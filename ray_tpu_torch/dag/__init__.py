"""Lazy DAG authoring API.

Analog of /root/reference/python/ray/dag (DAGNode dag_node.py:23,
FunctionNode function_node.py:12, ClassNode class_node.py:16, InputNode
input_node.py:13): `.bind()` on remote functions/classes builds a lazy
graph; `.execute(input)` submits it as ray_tpu_torch tasks/actors bottom-up.
Used by Workflow for durable execution.
"""

from ray_tpu_torch.dag.dag_node import (ClassMethodNode, ClassNode, DAGNode,
                                  ExistingActorNode, FunctionNode, InputNode)


def __getattr__(name):
    # compiled-DAG types import the runtime; load them lazily so plain
    # graph authoring never pays for it
    if name in ("CompiledDAG", "CompiledDAGRef"):
        from ray_tpu_torch.dag import compiled_dag
        return getattr(compiled_dag, name)
    raise AttributeError(name)


__all__ = ["DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode",
           "ExistingActorNode", "InputNode", "CompiledDAG",
           "CompiledDAGRef"]

"""The port stands alone: no module of ray_tpu_torch, and not
chip_smoke.py, imports jax, flax or anything of ray_tpu, nor the
third-party packages ray_tpu's runtime needs that the card's machine may
lack (cloudpickle: the port vendors its own; msgpack; psutil; aiohttp:
the port's HTTP proxy is the standard library's), and no
``-m`` argument or ``import_module`` string names a ray_tpu module (it
would quietly spawn ray_tpu's daemons)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu",
             "cloudpickle", "msgpack", "psutil", "aiohttp")


def _sources():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
        elif isinstance(node, (ast.List, ast.Tuple)):
            # argv lists: [python, "-m", "ray_tpu.runtime.raylet", ...]
            elts = node.elts
            for flag, mod in zip(elts, elts[1:]):
                if (isinstance(flag, ast.Constant) and flag.value == "-m"
                        and isinstance(mod, ast.Constant)
                        and isinstance(mod.value, str)
                        and _forbidden(mod.value)):
                    bad.append(f"-m {mod.value}")
    assert not bad, f"{path.name} imports {bad}"


def test_the_argv_check_sees_a_ray_tpu_daemon(tmp_path):
    """The check above refuses the argv string that would start ray_tpu's
    worker instead of the port's (mutation check on a copy of the
    raylet's spawn line)."""
    src = (ROOT / "ray_tpu_torch" / "runtime" / "raylet.py").read_text()
    line = '"-m", "ray_tpu_torch.runtime.worker_main"'
    assert line in src
    path = tmp_path / "raylet.py"
    path.write_text(src.replace(line, '"-m", "ray_tpu.runtime.worker_main"'))
    with pytest.raises(AssertionError, match="ray_tpu.runtime.worker_main"):
        test_no_jax_or_ray_tpu_imports(path)


def test_engine_import_leaves_jax_unloaded():
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.serve.llm_engine, "
            "ray_tpu_torch.models.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serve_import_leaves_jax_and_aiohttp_unloaded():
    """Plain Serve loads no model code of torch's; ``serve.llm``, the
    HTTP proxy and the trainer load nothing of FORBIDDEN (aiohttp
    included: the card's machine lacks it)."""
    code = ("import sys, ray_tpu_torch.serve; "
            "plain = 'ray_tpu_torch.models.gpt' in sys.modules; "
            "import ray_tpu_torch.serve.llm, ray_tpu_torch.serve.http_proxy, "
            "ray_tpu_torch.serve.frontdoor.sse, ray_tpu_torch.train, "
            "ray_tpu_torch.air; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(plain, bad); "
            "sys.exit(1 if bad or plain else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_data_and_tune_imports_leave_pandas_and_pyarrow_unloaded():
    """``ray_tpu_torch.data``, ``.tune`` and the predictors load nothing
    of FORBIDDEN, nor pandas or pyarrow (the card's machine has
    neither: dict-of-numpy and list blocks carry the port's paths)."""
    bad_names = FORBIDDEN + ("pandas", "pyarrow")
    code = ("import sys, ray_tpu_torch.data, ray_tpu_torch.tune, "
            "ray_tpu_torch.train.predictor; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{bad_names!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

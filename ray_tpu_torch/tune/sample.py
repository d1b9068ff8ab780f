"""Search-space primitives: the ``tune.uniform``/``grid_search`` vocabulary
(the port's copy of ray_tpu/tune/sample.py).

Analog of Ray's python/ray/tune/search/sample.py (Domain classes)
and variant_generator's grid handling.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float, base: float = 10.0):
        import math
        if low <= 0 or high <= 0:
            raise ValueError("loguniform bounds must be positive")
        self.low, self.high, self.base = low, high, base
        self._log = (math.log(low, base), math.log(high, base))

    def sample(self, rng):
        return self.base ** rng.uniform(*self._log)


class QUniform(Domain):
    def __init__(self, low: float, high: float, q: float):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return round(round(v / self.q) * self.q, 10)


class Randint(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class RandN(Domain):
    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class SampleFrom(Domain):
    """Defer to a callable of the (partially resolved) config."""

    def __init__(self, fn: Callable[[Dict[str, Any]], Any]):
        self.fn = fn


class GridSearch:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


# -- public constructors (ray.tune parity names) ----------------------------

def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float, base: float = 10.0) -> LogUniform:
    return LogUniform(low, high, base)


def quniform(low: float, high: float, q: float) -> QUniform:
    return QUniform(low, high, q)


def randint(low: int, high: int) -> Randint:
    return Randint(low, high)


def randn(mean: float = 0.0, sd: float = 1.0) -> RandN:
    return RandN(mean, sd)


def choice(categories: Sequence[Any]) -> Choice:
    return Choice(categories)


def sample_from(fn: Callable[[Dict[str, Any]], Any]) -> SampleFrom:
    return SampleFrom(fn)


def grid_search(values: Sequence[Any]) -> Dict[str, List[Any]]:
    return {"grid_search": list(values)}


def _is_grid(v: Any) -> bool:
    return (isinstance(v, GridSearch)
            or (isinstance(v, dict) and set(v.keys()) == {"grid_search"}))


def _grid_values(v: Any) -> List[Any]:
    return v.values if isinstance(v, GridSearch) else list(v["grid_search"])


def generate_variants(space: Dict[str, Any],
                      rng: Optional[random.Random] = None,
                      num_samples: int = 1) -> List[Dict[str, Any]]:
    """Expand grid axes (cartesian product) × num_samples random draws.

    Nested dicts are traversed; Domain leaves are sampled per variant;
    SampleFrom leaves resolve last against the flat config.
    """
    rng = rng or random.Random()

    grid_paths: List[Any] = []

    def collect(prefix, node):
        for k, v in node.items():
            path = prefix + (k,)
            if _is_grid(v):
                grid_paths.append((path, _grid_values(v)))
            elif isinstance(v, dict) and not _is_grid(v):
                collect(path, v)

    collect((), space)

    import itertools
    grid_combos = [()]
    if grid_paths:
        grid_combos = list(itertools.product(
            *[[(p, val) for val in vals] for p, vals in grid_paths]))

    def resolve(node, assignments, config_root):
        out = {}
        deferred = []
        for k, v in node.items():
            if _is_grid(v):
                out[k] = assignments[id(node)][k]
            elif isinstance(v, dict):
                out[k] = resolve(v, assignments, config_root)
            elif isinstance(v, Domain) and not isinstance(v, SampleFrom):
                out[k] = v.sample(rng)
            elif isinstance(v, SampleFrom):
                deferred.append((k, v))
            else:
                out[k] = v
        for k, v in deferred:
            out[k] = v.fn(out)
        return out

    variants = []
    for _ in range(num_samples):
        for combo in grid_combos:
            # map node-path assignments for this combo
            assign: Dict[str, Any] = {}

            def set_path(root, path, value):
                node = root
                for p in path[:-1]:
                    node = node[p]
                return node, path[-1], value

            # build an assignment lookup keyed by node identity
            per_node: Dict[int, Dict[str, Any]] = {}
            for path, value in combo:
                node = space
                for p in path[:-1]:
                    node = node[p]
                per_node.setdefault(id(node), {})[path[-1]] = value
            variants.append(resolve(space, per_node, space))
    return variants

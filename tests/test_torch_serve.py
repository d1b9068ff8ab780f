"""The port's Serve and ``LLMServer`` (ray_tpu_torch/serve/) held against
ray_tpu's on the CPU, on the tiny preset.

One JAX checkpoint (``ray_tpu.air.Checkpoint.from_dict({"params": ...})``
written to a directory) feeds both packages: ray_tpu's ``LLMServer`` runs
in this process through asyncio, and the port's through ``serve.run`` on
the port's runtime.  Both compute in fp32 on the CPU, as
``tests/test_torch_serving.py`` states, so greedy tokens must be
identical, with no tolerance: dense, paged, disaggregated (one prefill
and one decode replica), and with the int8 handoff codec on.  The codec's
wire bytes must equal ray_tpu's for the same fp32 input; its round trip
of a bf16 handoff stays within the codec's stated bound (blockmax / 254
per element) plus the bf16 rounding of the result.
"""

import os

# the conftest scales ray_tpu's liveness timeouts for a loaded box; the
# port reads its own prefix, so hand it the same scale
os.environ.setdefault("RAY_TPU_TORCH_TIMEOUT_SCALE",
                      os.environ.get("RAY_TPU_TIMEOUT_SCALE", "1.0"))

import asyncio  # noqa: E402
import fcntl  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.air.checkpoint import Checkpoint as JaxCheckpoint  # noqa: E402
from ray_tpu.models.configs import get_config as jax_config  # noqa: E402
from ray_tpu.models.gpt import GPT as JaxGPT  # noqa: E402
from ray_tpu.serve.llm import LLMServer as JaxLLMServer  # noqa: E402
from ray_tpu.util.collective.quant import Int8Codec as JaxCodec  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch.air.checkpoint import Checkpoint  # noqa: E402
from ray_tpu_torch.serve.controller import (REPLICA_PREFIX,  # noqa: E402
                                            SERVE_NAMESPACE)
from ray_tpu_torch.serve.llm import (LLMServer, _decode_handoff,  # noqa: E402
                                     _encode_handoff, build_app)
from ray_tpu_torch.serve.llm_engine import PrefillHandoff  # noqa: E402
from ray_tpu_torch.util.collective.quant import Int8Codec  # noqa: E402

TIMEOUT = 120 * float(os.environ["RAY_TPU_TORCH_TIMEOUT_SCALE"])

# six prompts in one bucket (16), more than the four slots
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [50, 60] * 4 + [61],
           list(range(20, 32)), [5] * 16, [200, 3]]
NEW = 8
ENGINE = dict(num_slots=4, block_size=4)
PAGE = 8


def _requests(prompts):
    return [{"prompt": p, "max_new_tokens": NEW, "temperature": 0.0}
            for p in prompts]


# ------------------------------------------------- one checkpoint, JAX side
def _jax_tiny_params():
    """ray_tpu's tiny GPT parameter tree (its leaves' names and shapes,
    from ``jax.eval_shape``, which compiles nothing), filled from a numpy
    seed: norm scales near 1, ``embed`` normal(0.02), kernels normal
    with variance 1 / fan_in (the stacked blocks' leaves lead with the
    layer axis)."""
    shapes = nn.meta.unbox(jax.eval_shape(
        lambda: JaxGPT(jax_config("tiny"), decode=True).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1), jnp.int32)))["params"])
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        keys = [k.key for k in path]
        x = rng.standard_normal(leaf.shape)
        if keys[-1] == "scale":
            x = 1.0 + 0.1 * x
        elif keys[-1] == "embed":
            x = 0.02 * x
        else:
            x = x / np.sqrt(leaf.shape[1 if keys[0] == "blocks" else 0])
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tree = _jax_tiny_params()
    path = str(tmp_path_factory.mktemp("ckpt"))
    JaxCheckpoint.from_dict({"params": tree}).to_directory(path)
    return path


def _server_kw(mode):
    """Each mode's LLMServer settings; both warm up with a burst of four
    1-token requests (which the dense engine ignores, as ray_tpu's)."""
    kw = dict(ENGINE, warmup_prompt_lens=[3], warmup_burst=4)
    if mode == "paged":
        kw.update(paged=True, page_size=PAGE)
    return kw


def _serve_in_process(server, prompts):
    async def go():
        return await asyncio.gather(*[server(r) for r in _requests(
            prompts)])
    return asyncio.run(go())


def _jax_int8_handoffs(engine):
    """What ray_tpu's disaggregated pools give with
    ``serve_handoff_quantize`` on, without its cluster (the store moves
    the encoded handoff unchanged): each prompt exported by ``engine``,
    through ray_tpu's ``_encode_handoff`` / ``_decode_handoff``, and
    imported back for decode.  The tokens, in order."""
    from ray_tpu.serve.llm import _decode_handoff as jax_decode
    from ray_tpu.serve.llm import _encode_handoff as jax_encode
    out = []
    for r in _requests(PROMPTS):
        h = jax_decode(jax_encode(engine.export_prefill(
            r["prompt"], max_new_tokens=NEW)))
        out.append(engine.import_prefill(h).tokens)
    return out


def _jax_runs(ckpt):
    out = {}
    for mode in ("dense", "paged"):
        server = JaxLLMServer("tiny", checkpoint=ckpt, **_server_kw(mode))
        try:
            warm = server.stats()
            results = _serve_in_process(server, PROMPTS)
            out[mode] = dict(warm=warm, tokens=[r["tokens"] for r in results],
                             stats=server.stats(),
                             load=server.engine.load_snapshot())
            if mode == "paged":
                out[mode]["int8"] = _jax_int8_handoffs(server.engine)
        finally:
            server.engine.close()
    return out


@pytest.fixture(scope="module")
def jax_runs(ckpt, tmp_path_factory):
    """ray_tpu's LLMServer, in this process, for each mode: its stats
    after warmup ("warm"), the tokens of PROMPTS, and its stats and
    engine load snapshot after them; paged, also the tokens of the int8
    handoff path ("int8").  Its engines' XLA compiles are most of this
    file's time, so under pytest-xdist the first worker to ask computes
    them and the others read its JSON (the run's temporary root is
    shared by its workers; the inputs come from fixed seeds)."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return _jax_runs(ckpt)
    path = tmp_path_factory.getbasetemp().parent / "jax_serve_runs.json"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_text(json.dumps(_jax_runs(ckpt)))
        return json.loads(path.read_text())


def _same_counts(ours, theirs):
    """Stats dicts equal in every key but those that depend on how
    arrivals fall into blocks (steps, occupancy)."""
    assert ours.keys() == theirs.keys()
    assert ({k: v for k, v in ours.items()
             if k not in ("steps", "batch_occupancy")}
            == {k: v for k, v in theirs.items()
                if k not in ("steps", "batch_occupancy")})
    assert ours["steps"] % ENGINE["block_size"] == 0


# ------------------------------------------------------- the port's cluster
class _Cluster:
    """The port's runtime, (re)started with or without the int8 handoff
    codec (a system_config knob that replica processes inherit)."""

    def __init__(self):
        self.quantize = None

    def use(self, quantize: Optional[bool] = None) -> None:
        """``quantize`` None: either cluster will do."""
        if ray_tpu_torch.is_initialized() and quantize in (None,
                                                            self.quantize):
            return
        self.stop()
        # one faked card, so a GPU lease can be seen on the CPU (the
        # raylet reads the variable at start)
        saved = os.environ.get("RAY_TPU_TORCH_GPUS_PER_HOST")
        os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"] = "1"
        try:
            # the codec's saved-bytes counter is read from the metric
            # plane, so flush it often
            ray_tpu_torch.init(
                num_cpus=4, object_store_memory=256 << 20,
                system_config=({"serve_handoff_quantize": True,
                                "telemetry_flush_interval_ms": 200}
                               if quantize else None))
        finally:
            if saved is None:
                del os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"]
            else:
                os.environ["RAY_TPU_TORCH_GPUS_PER_HOST"] = saved
        self.quantize = bool(quantize)
        serve.start()

    def stop(self) -> None:
        if ray_tpu_torch.is_initialized():
            serve.shutdown()
            ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def cluster():
    c = _Cluster()
    yield c
    c.stop()


def _get(ref):
    return ray_tpu_torch.get(ref, timeout=TIMEOUT)


def _replica_stats(name):
    tags = serve.status()[name]["replicas"]
    return [_get(ray_tpu_torch.get_actor(
        REPLICA_PREFIX + tag, namespace=SERVE_NAMESPACE
    ).handle_request.remote("stats", (), {})) for tag in tags]


def _stream_all(handle, requests):
    """Drive concurrent streams through a DisaggHandle: (tokens,
    summary) per request, in order."""
    async def one(req):
        toks, summary = [], None
        async for item in handle.stream(req):
            if "token" in item:
                toks.append(item["token"])
            elif "retry" not in item:
                summary = item
        return toks, summary

    async def main():
        return await asyncio.gather(*[one(r) for r in requests])
    return asyncio.run(asyncio.wait_for(main(), TIMEOUT))


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_llmserver_matches_jax_llmserver(cluster, ckpt, jax_runs, mode):
    """The port's app from ray_tpu's checkpoint, through serve.run and a
    handle, gives ray_tpu's LLMServer's greedy tokens, and its replica's
    stats count as ray_tpu's after the same warmup and requests."""
    cluster.use()
    name = f"llm-tiny-{mode}"
    handle = serve.run(build_app("tiny", checkpoint=ckpt, device="cpu",
                                 **_server_kw(mode)), name=name)
    want = jax_runs[mode]
    try:
        outs = _get([handle.remote(r) for r in _requests(PROMPTS)])
        for i, (got, tokens) in enumerate(zip(outs, want["tokens"])):
            assert got["tokens"] == tokens, f"request {i} diverged"
            assert got["finish_reason"] == "length"
            assert got["prompt_len"] == len((PROMPTS)[i])
        (stats,) = _replica_stats(name)
        _same_counts(stats, want["stats"])
        assert stats["role"] == "colocated" and stats["steps"] > 0
        if mode == "paged":
            # the stream yields each token, then the summary
            items = [_get(r) for r in handle.stream.remote_streaming(
                _requests(PROMPTS[:1])[0])]
            assert [x["token"] for x in items[:-1]] == want["tokens"][0]
            assert items[-1]["num_tokens"] == NEW
            assert items[-1]["finish_reason"] == "length"
    finally:
        serve.delete(name)


@pytest.mark.parametrize("quantize", [False, True],
                         ids=["raw", "int8_codec"])
def test_disagg_matches_jax_and_separates_pools(cluster, ckpt, jax_runs,
                                                quantize):
    """One prefill and one decode replica: the streamed greedy tokens are
    ray_tpu's (those of ray_tpu's int8 handoff path with the codec on);
    every prefill ran in the prefill pool and every decode step in the
    decode pool, as ray_tpu's test_disagg_streaming_smoke counts them.
    Raw handoffs show both HANDOFF timeline stages; with the codec the
    prefill replica counts the bytes it did not ship."""
    cluster.use(quantize)
    serve.run(build_app("tiny", checkpoint=ckpt, device="cpu",
                        disaggregated=True, prefill_replicas=1,
                        num_replicas=1, page_size=PAGE, **ENGINE))
    try:
        outs = _stream_all(serve.llm.disagg_handle("tiny"),
                           _requests(PROMPTS))
        want = jax_runs["paged"]["int8" if quantize else "tokens"]
        for i, ((toks, summary), w) in enumerate(zip(outs, want)):
            assert toks == w, f"request {i} diverged"
            assert summary["finish_reason"] == "length"
            assert summary["num_tokens"] == NEW
        (pre,) = _replica_stats("llm-tiny-prefill")
        (dec,) = _replica_stats("llm-tiny-decode")
        n = len(PROMPTS)
        assert (pre["role"], dec["role"]) == ("prefill", "decode")
        assert pre["prefills"] == pre["exports"] == n and pre["steps"] == 0
        assert dec["imports"] == n and dec["prefills"] == 0
        if quantize:
            from ray_tpu_torch.experimental.state.api import list_metrics
            saved, deadline = 0.0, time.monotonic() + TIMEOUT
            while saved <= 0 and time.monotonic() < deadline:
                saved = sum(r.get("value", 0.0) for r in list_metrics(
                    "ray_tpu_serve_handoff_saved_bytes"))
                time.sleep(0.2)
            assert saved > 0, "no handoff bytes were saved"
        else:
            from ray_tpu_torch.experimental.state.api import timeline
            stages, deadline = set(), time.monotonic() + TIMEOUT
            while (stages != {"export", "import"}
                   and time.monotonic() < deadline):
                stages = {e["args"]["stage"] for e in timeline()
                          if e.get("cat") == "handoff"}
                time.sleep(0.2)
            assert stages == {"export", "import"}, stages
    finally:
        serve.delete("llm-tiny-decode")
        serve.delete("llm-tiny-prefill")


def test_function_deployment_routes_to_both_replicas(cluster):
    cluster.use()

    @serve.deployment(num_replicas=2)
    def whoami(_):
        return os.getpid()

    handle = serve.run(whoami.bind())
    try:
        pids = set(_get([handle.remote(None) for _ in range(20)]))
        assert len(pids) == 2, f"expected both replicas hit, got {pids}"
        assert os.getpid() not in pids
    finally:
        serve.delete("whoami")


def test_serve_batch_coalesces(cluster):
    cluster.use()

    @serve.deployment(max_concurrent_queries=8)
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, xs):
            return [(x * 10, len(xs)) for x in xs]

    handle = serve.run(Batched.bind())
    try:
        outs = _get([handle.remote(i) for i in range(8)])
        assert [v for v, _ in outs] == [i * 10 for i in range(8)]
        assert max(size for _, size in outs) > 1, outs
    finally:
        serve.delete("Batched")


def test_replica_leases_gpu_through_the_controller(cluster):
    """``ray_actor_options={"num_gpus": ...}`` (what build_app gives a
    replica) reaches the raylet as a GPU lease: the replica sees its
    card, and the lease shows in the cluster's free GPUs."""
    cluster.use()

    @serve.deployment(ray_actor_options={"num_gpus": 0.5})
    def card(_):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    handle = serve.run(card.bind())
    try:
        assert _get(handle.remote(None)) == "0"
        free, deadline = None, time.monotonic() + TIMEOUT
        while free != 0.5 and time.monotonic() < deadline:
            free = ray_tpu_torch.available_resources().get("GPU")
            time.sleep(0.1)
        assert free == 0.5
    finally:
        serve.delete("card")


@ray_tpu_torch.remote
def _server_without_gpu():
    """What LLMServer(device=None) does in a worker with no GPU lease."""
    try:
        LLMServer("tiny")
    except RuntimeError as e:
        return os.environ.get("CUDA_VISIBLE_DEVICES"), str(e)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), None


def test_replica_without_gpu_lease_refuses_the_card(cluster):
    cluster.use()
    visible, err = _get(_server_without_gpu.remote())
    assert visible == ""
    assert err is not None and "no CUDA device" in err


# ------------------------------------------------------- no cluster needed
def test_build_app_options_name_num_gpus():
    app = build_app("tiny", num_gpus=1, device="cpu")
    assert app.deployment.config.ray_actor_options == {"num_gpus": 1}
    assert app.deployment.name == "llm-tiny"
    dis = build_app("tiny", num_gpus=0.5, disaggregated=True)
    prefill = dis.init_kwargs["_upstream"]
    for a, role in ((dis, "decode"), (prefill, "prefill")):
        assert a.deployment.config.ray_actor_options == {"num_gpus": 0.5}
        assert a.init_kwargs["role"] == role and a.init_kwargs["paged"]
    assert build_app("tiny").deployment.config.ray_actor_options in (None,
                                                                     {})


def test_checkpoint_reads_ray_tpus_directory_and_round_trips(ckpt, tmp_path):
    """ray_tpu's directory reads here as written; the port's dict, bytes
    and directory forms round-trip a state dict of tensors."""
    ours = Checkpoint.from_directory(ckpt).to_dict()
    theirs = JaxCheckpoint.from_directory(ckpt).to_dict()
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(ours), jax.tree.leaves(theirs)))
    sd = {"w": torch.arange(6.0).view(2, 3).to(torch.bfloat16)}
    back = Checkpoint.from_bytes(Checkpoint.from_dict(
        {"params": sd}).to_bytes()).to_dict()
    path = Checkpoint.from_dict(back).to_directory(str(tmp_path / "c"))
    got = Checkpoint.from_directory(path).to_dict()["params"]["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, sd["w"])


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096])
def test_quant_codec_bytes_match_jax(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    x[: n // 3] *= 40.0
    if n >= 512:
        x[256:512] = 0.0          # an all-zero block
    ours, theirs = Int8Codec(256), JaxCodec(256)
    wire = ours.encode(x)
    assert wire.dtype == np.uint8 and wire.nbytes == ours.wire_nbytes(n)
    assert wire.tobytes() == theirs.encode(x).tobytes()
    assert np.array_equal(ours.decode(wire, n), theirs.decode(wire, n))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_handoff_codec_round_trip(dtype):
    """A handoff's kv through ``_encode_handoff`` / ``_decode_handoff``:
    int8 wire bytes, ray_tpu's dtype name, and a tensor of the pool's
    dtype within blockmax / 254 of each element (plus the result's own
    rounding: half an ulp of bf16, at most 2^-8 relative)."""
    kv = (torch.randn(2, 3, 2, 8, 32,
                      generator=torch.Generator().manual_seed(0)) * 3
          ).to(dtype)
    h = PrefillHandoff(kv=kv.clone(), page_size=8, npages=3, prompt_len=20,
                       first_token=5, max_new_tokens=4, temperature=0.0,
                       eos_id=None)
    raw = h.nbytes
    h = _encode_handoff(h)
    assert h.codec == "int8" and h.raw_nbytes == raw
    assert h.kv_dtype == {torch.bfloat16: "bfloat16",
                          torch.float32: "float32"}[dtype]
    assert h.nbytes == Int8Codec(256).wire_nbytes(kv.numel()) < raw
    h = _decode_handoff(h)
    assert h.codec is None and torch.is_tensor(h.kv)
    assert h.kv.dtype == dtype and h.kv.shape == kv.shape
    x = kv.float().reshape(-1)
    blockmax = x.abs().view(-1, 256).amax(dim=1).repeat_interleave(256)
    rounding = x.abs() * 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    err = (h.kv.float().reshape(-1) - x).abs()
    # the codec's own fp32 arithmetic: a few ulps of blockmax
    assert bool((err <= blockmax * (1 / 254 + 1e-6) + rounding).all())


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_engine_snapshots_match_jax(ckpt, jax_runs, mode):
    """The port's LLMServer in this process: ``stats()``
    (``EngineStats.snapshot``) after warmup and after the requests, and
    ``LLMEngine.load_snapshot``, keyed and counted as ray_tpu's."""
    server = LLMServer("tiny", checkpoint=ckpt, device="cpu",
                       **_server_kw(mode))
    want = jax_runs[mode]
    try:
        assert server.stats() == want["warm"]
        results = _serve_in_process(server, PROMPTS)
        assert [r["tokens"] for r in results] == want["tokens"]
        _same_counts(server.stats(), want["stats"])
        assert server.engine.load_snapshot() == want["load"]
    finally:
        server.engine.close()


def test_warmup_burst_from_a_running_event_loop(ckpt, jax_runs):
    """An async replica builds its server inside a running event loop:
    ``warmup(burst=4)`` then drives the burst from a helper thread, and
    it counts as ray_tpu's burst does (four prefills, four requests)."""
    async def build():
        return LLMServer("tiny", checkpoint=ckpt, device="cpu",
                         **_server_kw("paged"))
    server = asyncio.run(build())
    try:
        assert server.stats() == jax_runs["paged"]["warm"]
        assert server.stats()["prefills"] == 4
        assert server.engine.load_snapshot()["busy_slots"] == 0
    finally:
        server.engine.close()


def test_serve_http_proxy_is_refused_naming_the_roadmap(cluster):
    """The name is the first slice's, which refused the proxy naming the
    ROADMAP item.  The front door is ported now (tests/test_torch_http.py
    holds it against ray_tpu's): no refusal is left, and asking for the
    proxy starts one that answers."""
    import urllib.request

    from ray_tpu_torch.serve import api
    from ray_tpu_torch.serve.config import HTTPOptions
    assert not hasattr(api, "NO_HTTP_PROXY")
    cluster.use()
    api._ensure_proxy(HTTPOptions(port=0))
    proxy = ray_tpu_torch.get_actor(api.PROXY_NAME,
                                    namespace=SERVE_NAMESPACE)
    host, port = _get(proxy.address.remote())
    with urllib.request.urlopen(f"http://{host}:{port}/-/healthz",
                                timeout=TIMEOUT) as resp:
        assert resp.read() == b"ok"

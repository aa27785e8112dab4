"""int8 serving on the port's paged engine against the JAX package's:
``ServeConfig(kv_dtype="int8")`` (int8 KV pages, the write path freezing
each page's scale at its first row) and ``weight_dtype="int8"`` (W8A8
GEMMs over weights quantized at pack time). Greedy streams of the int8 KV
engine must be token-identical. W8A8 streams are token-identical until a
value the two packages computed an ulp apart in fp32 (rmsnorm, RoPE,
attention sum in other orders) rounds to another int8 value on a .5 tie;
where a W8A8 stream parts, the test records every quantization of both
runs and holds the divergence to exactly that (tests/int8_flips.py), and
prints the count of differing int8 values and the plain top-2 logit margin
where the stream parted.

The smoke config is tests/test_serving.py's ``paged_setup`` (smollm-135m,
2 layers, vocab 64) in fp32, as the port's other serving tests run it, with
the JAX weights carried over by ``convert.from_jax_params``. The JAX engine
runs its paged kernel in interpret mode; its GEMMs run on ``xla`` for fp
weights and ``blockflow`` for W8A8. The port runs on the CPU, where its
kernel wrappers run their plain versions.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax
import numpy as np
import pytest
import torch
from int8_flips import Recorder, check_tie_flip, row_scales

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import quant as JQ
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import (FUSED, AttentionPolicy, GemmPolicy,
                                   QuantizedPackedWeight)
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeConfig, ServingEngine

PS = 8
INT8_KV = dict(kv_dtype="int8")
W8A8 = dict(kv_dtype="int8", weight_dtype="int8")


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_layers=2, vocab=64, dtype="float32")
    jcfg = jget_smoke_config("smollm-135m", **kw)
    cfg = get_smoke_config("smollm-135m", **kw)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def _port(setup, **kw):
    cfg, params = setup[2:]
    return ServingEngine(cfg, params, ServeConfig(
        cache_dtype="float32", device="cpu",
        attention=AttentionPolicy(backend="paged", page_size=PS), **kw))


def _jax(setup, **kw):
    jcfg, jparams = setup[:2]
    backend = "blockflow" if kw.get("weight_dtype") else "xla"
    return JServingEngine(jcfg, jparams, JServeConfig(
        cache_dtype="float32", gemm=JGemmPolicy(backend=backend),
        attention=JAttentionPolicy(backend="paged_interpret", page_size=PS,
                                   block_q=8), **kw))


def _drain(eng, prompts, max_steps=200):
    """Submit every prompt as slots/pages allow and step until all finish
    (retirement at max_len); returns the streams in submit order."""
    pending, rids = list(prompts), []
    for _ in range(max_steps):
        while pending:
            rid = eng.submit(pending[0])
            if rid is None:
                break
            rids.append(rid)
            pending.pop(0)
        eng.step()
        if not pending and not eng.slot_live.any() and not eng.wait:
            break
    assert not pending and not eng.slot_live.any() and not eng.wait
    return [eng.request_out[r] for r in rids]


class _Recorder(Recorder):
    """int8_flips.Recorder over both packages: the port's calls in
    ``port``, the JAX package's in ``jax`` (through ordered debug callbacks
    from inside its jitted steps)."""

    def __enter__(self):
        super().__enter__()
        self.port, self.jax = self.calls, []
        self.jax_saved = (JQ.quantize_activations, JQ.quantize_kv_rows)
        jqa, jqkv = self.jax_saved

        def record(x, sc, q):
            x = np.asarray(x, np.float32)
            sc = row_scales(x) if sc is None else \
                np.asarray(sc, np.float32)[..., None]
            self.jax.append((x, sc, np.asarray(q)))

        def act(x):
            out = jqa(x)
            jax.debug.callback(lambda a, b: record(a, None, b), x, out[0],
                               ordered=True)
            return out

        def kv(rows, scales):
            out = jqkv(rows, scales)
            jax.debug.callback(record, rows, scales, out, ordered=True)
            return out

        JQ.quantize_activations, JQ.quantize_kv_rows = act, kv
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        JQ.quantize_activations, JQ.quantize_kv_rows = self.jax_saved
        super().__exit__(*exc)


def _same_or_tie_flip(rec, got, want, label):
    """Streams equal; or W8A8 streams that part from JAX's only because a
    value the packages computed an ulp apart crossed a .5 tie of the int8
    grid (int8_flips.check_tie_flip). Returns None, or the report."""
    if got == want:
        return None
    step = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))
    return check_tie_flip(rec.port, rec.jax, label=label, stream_step=step)


def _margin(setup, prompt, stream, report):
    """The port's plain top-2 logit margin where the stream diverged."""
    if report is None:
        return None
    cfg, params = setup[2:]
    toks = torch.tensor([prompt + stream[:report["stream_step"]]])
    with api.use_policy(GemmPolicy(weight_dtype="int8")):
        logits, _, _ = T.forward(params, cfg, {"tokens": toks})
    top2 = logits[0, -1].topk(2).values
    report["margin"] = float(top2[0] - top2[1])
    print(f"W8A8 stream diverges from JAX at a tie flip: {report}")
    return report


@pytest.mark.parametrize("kw", [INT8_KV, W8A8], ids=["int8_kv", "w8a8"])
def test_generate_streams_match_jax(setup, kw):
    prompts = np.random.default_rng(5).integers(0, 64, (2, 6)).astype(np.int32)
    with _Recorder() as rec:
        want = np.asarray(_jax(setup, batch_slots=2, max_len=32, **kw)
                          .generate(prompts, 7))
        got = _port(setup, batch_slots=2, max_len=32, **kw).generate(
            prompts, 7)
    for b in range(2):
        flip = _same_or_tie_flip(rec, got[b].tolist(), want[b].tolist(),
                                 f"generate row {b}")
        assert flip is None or kw is W8A8, flip
        _margin(setup, prompts[b].tolist(), got[b].tolist(), flip)


@pytest.mark.parametrize("kw", [INT8_KV, W8A8], ids=["int8_kv", "w8a8"])
def test_submit_step_streams_match_jax(setup, kw):
    """Five requests of mixed lengths through two slots, to retirement."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 64, n).tolist() for n in (3, 9, 1, 6, 12)]
    with _Recorder() as rec:
        want = _drain(_jax(setup, batch_slots=2, max_len=16, **kw), prompts)
        got = _drain(_port(setup, batch_slots=2, max_len=16, **kw), prompts)
    for p, g, w in zip(prompts, got, want):
        flip = _same_or_tie_flip(rec, g, w, f"request {p}")
        assert flip is None or kw is W8A8, flip
        _margin(setup, p, g, flip)


@pytest.mark.parametrize("kw", [INT8_KV, W8A8], ids=["int8_kv", "w8a8"])
def test_submit_step_equals_generate(setup, kw):
    """tests/test_serving.py:752 on the port: one request's submit/step
    stream equals its row of a batched generate() on the same config."""
    prompt = [3, 1, 4, 1, 5]
    eng = _port(setup, batch_slots=2, max_len=32, **kw)
    h = eng.submit(prompt)
    stream = [eng.step()[h] for _ in range(6)]
    gen = _port(setup, batch_slots=2, max_len=32, **kw).generate(
        np.asarray([prompt, prompt], np.int32), 6)
    assert stream == gen[0].tolist() == gen[1].tolist()


@pytest.mark.parametrize("kw", [INT8_KV, W8A8], ids=["int8_kv", "w8a8"])
def test_preempt_resume_streams_identical(setup, kw):
    """tests/test_serving.py:774 on the port: an int8 pool of 2 pages
    forces preemption; resume re-prefills in bulk what decode wrote a
    token at a time, so streams stay identical only because frozen page
    scales make the int8 payload a pure function of the page's content.
    Every stream equals its solo run and the JAX engine's."""
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8]]
    eng = _port(setup, batch_slots=2, max_len=16, cache_pages=2, **kw)
    got = _drain(eng, prompts)
    assert eng.n_preemptions > 0
    eng.pool.check()
    assert eng.pool.free_pages == eng.pool.n_pages
    for p, g in zip(prompts, got):
        solo = _port(setup, batch_slots=2, max_len=16, cache_pages=2, **kw)
        assert _drain(solo, [p]) == [g], p
    with _Recorder() as rec:
        want = _drain(_jax(setup, batch_slots=2, max_len=16, cache_pages=2,
                           **kw), prompts)
        got = _drain(_port(setup, batch_slots=2, max_len=16, cache_pages=2,
                           **kw), prompts)
    for p, g, w in zip(prompts, got, want):
        flip = _same_or_tie_flip(rec, g, w, f"preempted request {p}")
        assert flip is None or kw is W8A8, flip
        _margin(setup, p, g, flip)


def test_weight_dtype_implies_quantize_at_pack(setup):
    eng = _port(setup, batch_slots=2, max_len=16, weight_dtype="int8")
    assert isinstance(eng.params["head"], QuantizedPackedWeight)
    wq = eng.params["layers"][0]["attn"]["wq"]
    assert isinstance(wq, QuantizedPackedWeight) and wq.dtype == torch.int8
    assert eng.gemm.weight_dtype == "int8"
    assert not isinstance(_port(setup, batch_slots=2, max_len=16)
                          .params["head"], QuantizedPackedWeight)


def test_kv_dtype_requires_paged_backend(setup):
    cfg, params = setup[2:]
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, params, ServeConfig(
            cache_dtype="float32", device="cpu", attention=FUSED,
            kv_dtype="int8"))
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeConfig(kv_dtype="int4").attn_policy()
    with pytest.raises(ValueError, match="weight_dtype"):
        ServeConfig(weight_dtype="int4").policy()


def test_stats_pool_bytes():
    """tests/test_serving.py:831 on the port: stats() reports the pool's
    bytes; an int8 page (payload plus fp32 scale rows) costs at most
    1/1.8 of a bf16 page."""
    cfg = get_smoke_config("smollm-135m", n_layers=2, vocab=64)
    params = T.init_model(cfg, seed=0, device="cpu")
    base = dict(batch_slots=2, max_len=32, cache_pages=8,
                cache_dtype="bfloat16", device="cpu",
                attention=AttentionPolicy(backend="paged", page_size=PS))
    fp = ServingEngine(cfg, params, ServeConfig(**base))
    q8 = ServingEngine(cfg, params, ServeConfig(**base, kv_dtype="int8"))
    st = q8.stats()
    assert st["kv_dtype"] == "int8" and fp.stats()["kv_dtype"] == "bfloat16"
    assert st["kv_page_bytes"] == q8.kv_page_bytes()
    assert st["kv_pool_bytes"] == 8 * st["kv_page_bytes"]
    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    assert q8.kv_page_bytes() == L * 2 * (PS * Hkv * dh + 4 * Hkv)
    assert fp.kv_page_bytes() == L * 2 * PS * Hkv * dh * 2
    assert 1.8 * q8.kv_page_bytes() <= fp.kv_page_bytes()
    q8.submit([1, 2, 3])
    st = q8.stats()
    assert st["kv_bytes_in_use"] == \
        st["kv_page_bytes"] * st["pool_pages_in_use"] > 0
    c = q8.caches[0]
    assert c["kp"].dtype == c["vp"].dtype == torch.int8
    assert c["k_scale"].dtype == c["v_scale"].dtype == torch.float32


def test_serve_cli_int8_on_cpu(capsys):
    assert serve_cli.main(["--arch", "smollm-135m", "--smoke", "--device",
                           "cpu", "--max-len", "32", "--batch-slots", "2",
                           "--n-requests", "3", "--prompt-len", "6",
                           "--gen-len", "4", "--page-size", "8",
                           "--cache-pages", "4", "--weight-dtype", "int8",
                           "--kv-dtype", "int8"]) == 0
    out = capsys.readouterr().out
    assert "weight_dtype=int8 kv_dtype=int8" in out
    assert "continuous batching: 3 requests" in out
    assert "'kv_dtype': 'int8'" in out
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                        "--attn-backend", "fused", "--kv-dtype", "int8"])

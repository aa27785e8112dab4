"""The port's serving engine on the SSM families (mamba2-1.3b and the
zamba2-2.7b hybrid, smoke configs, fp32) against the JAX package's engine
on the same converted weights: greedy streams token-identical.

Both engines serve from contiguous caches (the port under the fused
policy, whose flash kernel the hybrid's shared attention block runs; the
JAX engine under its unfused baseline, xla GEMMs). Covered: generate(),
single-slot submit/step with an unpadded non-power-of-two prefill, a
recycled slot whose conv and SSD state is zeroed, and the refusals: multi-
slot submit(), the paged policy, and chunked prefill (which would drop the
earlier chunks' SSD state). With ``weight_dtype="int8"`` (every projection
through the W8A8 route, the JAX engine's on ``blockflow``) greedy streams
are equal, or part only after an int8 value the packages rounded to either
side of a .5 tie from an ulp apart (tests/int8_flips.py).
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax
import numpy as np
import pytest

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core.plan import UNFUSED as JUNFUSED
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.plan import FUSED, PAGED
from repro_torch.kernels import ssd_scan as K6
from repro_torch.launch import serve as serve_cli
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.scheduler import Scheduler
from test_torch_int8_serving import _Recorder, _same_or_tie_flip

ARCHS = ("mamba2-1.3b", "zamba2-2.7b")


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    kw = dict(vocab=64, dtype="float32")
    jcfg = jget_smoke_config(request.param, **kw)
    cfg = get_smoke_config(request.param, **kw)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def _jax_engine(setup, **kw):
    jcfg, jparams, _, _ = setup
    backend = "blockflow" if kw.get("weight_dtype") else "xla"
    return JServingEngine(jcfg, jparams, JServeConfig(
        cache_dtype="float32", gemm=JGemmPolicy(backend=backend),
        attention=JUNFUSED, **kw))


def _engine(setup, attention=FUSED, **kw):
    _, _, cfg, params = setup
    return ServingEngine(cfg, params, ServeConfig(
        cache_dtype="float32", device="cpu", attention=attention, **kw))


def _stream(eng, prompt, n):
    h = eng.submit(prompt)
    assert h == 0
    out = [eng.step()[h] for _ in range(n)]
    assert eng.cancel(h)
    return out


def test_generate_streams_identical(setup):
    prompts = np.random.default_rng(5).integers(0, 64, (2, 7)).astype(np.int32)
    want = _jax_engine(setup, batch_slots=2, max_len=32).generate(prompts, 6)
    eng = _engine(setup, batch_slots=2, max_len=32)
    before = K6.ssd_scan.launches
    np.testing.assert_array_equal(eng.generate(prompts, 6), want)
    assert K6.ssd_scan.launches == before                 # CPU: no launch
    # generate() restarts every slot: the conv and SSD states are zeroed
    np.testing.assert_array_equal(eng.generate(prompts, 6), want)


def test_w8a8_generate_streams_match_jax(setup):
    """Two 11-token prompts, 16 tokens each, every projection W8A8."""
    prompts = np.random.default_rng(11).integers(0, 64, (2, 11)).astype(
        np.int32)
    with _Recorder() as rec:
        want = np.asarray(_jax_engine(setup, batch_slots=2, max_len=32,
                                      weight_dtype="int8").generate(prompts, 16))
        got = _engine(setup, batch_slots=2, max_len=32,
                      weight_dtype="int8").generate(prompts, 16)
    assert got.shape == want.shape == (2, 16)
    for b in range(2):
        flip = _same_or_tie_flip(rec, got[b].tolist(), want[b].tolist(),
                                 f"{setup[2].name} generate row {b}")
        if flip is not None:
            print(f"W8A8 stream diverges from JAX at a tie flip: {flip}")


def test_submit_rejects_multislot(setup):
    """SSD/conv state carries no positions: a masked single-slot prefill
    cannot protect the other slots, so submit() refuses with more than one
    slot (tests/test_serving.py::test_submit_rejects_multislot_ssm)."""
    eng = _engine(setup, batch_slots=2, max_len=32)
    with pytest.raises(NotImplementedError, match="SSM"):
        eng.submit([1, 2, 3])
    solo = _engine(setup, batch_slots=1, max_len=32)
    assert solo.submit([1, 2, 3]) == 0
    assert set(solo.step()) == {0}


def test_single_slot_submit_equals_generate(setup):
    """A 3-token prompt would bucket to 4; the SSM prefill runs unpadded,
    so submit()/step() equals generate() and the JAX engine's submit()
    (tests/test_serving.py::test_ssm_submit_stream_unaffected_by_bucketing).
    """
    prompt = [7, 3, 11]
    gen = _engine(setup, batch_slots=1, max_len=32)
    want = gen.generate(np.asarray([prompt]), 5)[0].tolist()
    assert want == _jax_engine(setup, batch_slots=1, max_len=32).generate(
        np.asarray([prompt], np.int32), 5)[0].tolist()
    assert _stream(_engine(setup, batch_slots=1, max_len=32), prompt, 5) == want
    assert _stream(_jax_engine(setup, batch_slots=1, max_len=32), prompt,
                   5) == want


def test_recycled_slot_matches_fresh_engine(setup):
    """The second request on a recycled slot starts from zeroed conv and
    SSD states: its stream equals a fresh engine's and the JAX engine's."""
    first, second = [5, 9, 2, 33, 4], [12, 1, 40, 7, 7, 3, 21]
    eng = _engine(setup, batch_slots=1, max_len=32)
    jeng = _jax_engine(setup, batch_slots=1, max_len=32)
    assert _stream(eng, first, 6) == _stream(jeng, first, 6)
    got = _stream(eng, second, 6)
    assert got == _stream(_engine(setup, batch_slots=1, max_len=32), second, 6)
    assert got == _stream(jeng, second, 6)


def test_paged_policy_and_chunked_prefill_raise(setup):
    with pytest.raises(NotImplementedError, match="SSD recurrent state"):
        _engine(setup, attention=PAGED, batch_slots=1, max_len=32)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        _engine(setup, batch_slots=1, max_len=32,
                scheduler=Scheduler(prefill_chunk=4))


def test_serve_cli(setup, capsys):
    """The CLI on the CPU: single-slot continuous batching runs; with more
    slots it is skipped with a line, as the reference CLI does."""
    name = setup[2].name
    args = ["--arch", name, "--smoke", "--device", "cpu", "--attn-backend",
            "fused", "--max-len", "24", "--n-requests", "2", "--prompt-len",
            "6", "--gen-len", "3"]
    assert serve_cli.main(args + ["--batch-slots", "1"]) == 0
    out = capsys.readouterr().out
    assert "continuous batching: 2 requests, 6 tokens" in out
    assert serve_cli.main(args + ["--batch-slots", "2"]) == 0
    assert "continuous batching skipped" in capsys.readouterr().out

"""Mamba-2 and Zamba-2 under the port's default attention policy.

The JAX engine serves the SSD families with a default ``ServeConfig()``
(contiguous caches); so does the port: ``attention=None`` or ``auto``
resolves to a contiguous backend for the ``ssm`` and ``hybrid`` families
(``fused`` on the card, ``unfused`` on the CPU), while dense decoders keep
the paged default and an explicit ``PAGED`` policy still raises for the
SSD families. The CLI with no ``--attn-backend`` serves both archs.

Smoke configs in fp32, weights converted from the JAX package; greedy
streams token-identical to the JAX engine built the same way
(tests/test_serving.py::test_submit_rejects_multislot_ssm and
::test_ssm_submit_stream_unaffected_by_bucketing build theirs with the
default ServeConfig).
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax
import numpy as np
import pytest

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.models import transformer as JT
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.plan import (PAGED, AttentionPolicy,
                                   resolve_attention_backend)
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeConfig, ServingEngine

ARCHS = ("mamba2-1.3b", "zamba2-2.7b")
KW = dict(vocab=64, dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jget_smoke_config(request.param, **KW)
    cfg = get_smoke_config(request.param, **KW)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, params


def _engines(setup, **kw):
    """The port's and the JAX package's engines, each with its default
    policies (only the device and the cache dtype are set)."""
    jcfg, jparams, cfg, params = setup
    return (ServingEngine(cfg, params, ServeConfig(
                cache_dtype="float32", device="cpu", **kw)),
            JServingEngine(jcfg, jparams, JServeConfig(
                cache_dtype="float32", **kw)))


def test_default_policy_generate_streams_identical(setup):
    eng, jeng = _engines(setup, batch_slots=2, max_len=32)
    assert not eng.paged and eng.attn.backend == "unfused"
    prompts = np.random.default_rng(11).integers(0, 64, (2, 9)).astype(
        np.int32)
    got = eng.generate(prompts, 8)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, jeng.generate(prompts, 8))


def test_default_policy_single_slot_submit(setup):
    """batch_slots=1, max_len=32 with the default ServeConfig: submit()
    and step() serve, token-identical to the JAX engine's."""
    eng, jeng = _engines(setup, batch_slots=1, max_len=32)
    prompt = [7, 3, 11, 40, 2]
    streams = []
    for e in (eng, jeng):
        h = e.submit(prompt)
        assert h == 0
        streams.append([e.step()[h] for _ in range(8)])
    assert streams[0] == streams[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_explicit_paged_raises_auto_resolves_contiguous(arch):
    cfg = get_smoke_config(arch, **KW)
    params = T.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="SSD recurrent state"):
        ServingEngine(cfg, params, ServeConfig(
            attention=PAGED, batch_slots=1, max_len=32,
            cache_dtype="float32", device="cpu"))
    eng = ServingEngine(cfg, params, ServeConfig(
        attention=AttentionPolicy("auto"), batch_slots=1, max_len=32,
        cache_dtype="float32", device="cpu"))
    assert (eng.paged, eng.attn.backend) == (False, "unfused")


def test_auto_resolution_by_family_and_device():
    """auto: paged on the card for dense decoders, fused for the SSD
    families; unfused on the CPU for both. Named backends pass through."""
    assert resolve_attention_backend("auto", "cuda") == "paged"
    assert resolve_attention_backend("auto", "cuda", pageable=False) == "fused"
    for pageable in (True, False):
        assert resolve_attention_backend("auto", "cpu",
                                         pageable=pageable) == "unfused"
        assert resolve_attention_backend("paged", "cuda",
                                         pageable=pageable) == "paged"
    dense = get_smoke_config("smollm-135m", **KW)
    eng = ServingEngine(dense, T.init_model(dense, seed=0, device="cpu"),
                        ServeConfig(batch_slots=1, max_len=32,
                                    cache_dtype="float32", device="cpu"))
    assert eng.paged and eng.attn.backend == "paged"


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_without_attn_backend(arch, capsys):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--max-len", "24",
            "--n-requests", "2", "--prompt-len", "6", "--gen-len", "3",
            "--batch-slots", "1"]
    assert serve_cli.main(args) == 0
    out = capsys.readouterr().out
    assert "attn=unfused" in out
    assert "continuous batching: 2 requests, 6 tokens" in out
    with pytest.raises(NotImplementedError, match="SSD recurrent state"):
        serve_cli.main(args + ["--attn-backend", "paged"])

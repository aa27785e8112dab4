"""The VLM and audio families in the port — internvl2-76b (image
embeddings ⊕ text tokens) and musicgen-medium (four EnCodec codebooks:
their embeddings summed, a head of vocab x 4) — against the JAX package on
their smoke configs, fp32, with the JAX weights converted.

internvl2: ``forward`` over image embeds ⊕ tokens without a cache, and a
prefill of the same over contiguous and over paged caches followed by
greedy text decode. musicgen: ``forward`` over (B, S, 4) tokens without a
cache, then a prefill and greedy decode (argmax per codebook) over
contiguous and paged caches; the logits are (B, S, 4, vocab). The port's engine refuses
musicgen, as the reference's cannot serve it either. Tolerances are
tests/parity.py's TOLS.
The JAX reference calls are jitted whole, each test compiling its own
under the policies active at its first call: eager JAX compiles every op
anew at each new shape, several times slower here.
"""
import torch_threads  # noqa: F401  (one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity import TOLS

from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core import api
from repro_torch.core.plan import FUSED, AttentionPolicy
from repro_torch.models import transformer as T
from repro_torch.serving.engine import ServeConfig, ServingEngine

JXLA = JGemmPolicy(backend="xla")
JUNFUSED = JAttentionPolicy(backend="unfused")
PS = 8
N_IMG = 6          # image embeddings of the smoke prompts


@pytest.fixture(scope="module", params=["internvl2-76b", "musicgen-medium"])
def model(request):
    kw = dict(n_layers=2, vocab=64, dtype="float32")
    jcfg = jget_smoke_config(request.param, **kw)
    cfg = get_smoke_config(request.param, **kw)
    jparams, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, np_tree),
            from_jax_params(np_tree, cfg))


def _prompt(cfg, B, S, seed):
    """Tokens (B, S) or (B, S, n_codebooks); for the VLM also image
    embeddings (B, N_IMG, d_model). numpy."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape)}
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal((B, N_IMG, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _columns(cfg, batch):
    return batch["tokens"].shape[1] + (N_IMG if "embeds" in batch else 0)


def test_cacheless_forward_matches_jax(model):
    jcfg, cfg, jparams, params = model
    batch = _prompt(cfg, 2, 9, seed=1)
    with japi.use_policy(JXLA), japi.use_attention_policy(JUNFUSED):
        want, _, _ = jax.jit(lambda p, b: JT.forward(p, jcfg, b, remat=False))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _, _ = T.forward(params, cfg,
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    S = _columns(cfg, batch)
    shape = (2, S, 4, cfg.vocab) if cfg.n_codebooks else (2, S, cfg.vocab)
    assert got.shape == shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               *TOLS["float32"])


def _greedy(logits_last, cfg):
    """The next token of each row from its last column's logits: (B, 1) or,
    per codebook, (B, 1, n_codebooks)."""
    nxt = np.asarray(logits_last).argmax(-1)
    return nxt[:, None]


@pytest.mark.parametrize("cache", ["contiguous", "paged"])
def test_prefill_and_decode_over_caches_match_jax(model, cache):
    """A prefill (internvl2: the image embeddings ⊕ text) then 3 greedy
    decode steps (musicgen: the argmax of each codebook), logits of every
    step within TOLS["float32"]."""
    jcfg, cfg, jparams, params = model
    B, max_len = 2, 24
    batch = _prompt(cfg, B, 7, seed=2)
    S = _columns(cfg, batch)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    if cache == "paged":
        nb = max_len // PS
        jcaches = JT.init_paged_caches(jcfg, B, B * nb, PS, jnp.float32)
        caches = T.init_paged_caches(cfg, B, B * nb, PS, "float32", "cpu")
        bt = np.arange(B * nb, dtype=np.int32).reshape(B, nb)
        jattn = JAttentionPolicy(backend="paged_interpret", page_size=PS,
                                 block_q=8)
        attn = AttentionPolicy(backend="paged", page_size=PS)
    else:
        jcaches = JT.init_caches(jcfg, B, max_len, jnp.float32)
        caches = T.init_caches(cfg, B, max_len, torch.float32, "cpu")
        bt, jattn, attn = None, JUNFUSED, FUSED
    ref = jax.jit(lambda p, b, c: JT.forward(p, jcfg, b, caches=c,
                                             remat=False))
    for i in range(4):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items()}
        jb["positions"], tb["positions"] = jnp.asarray(pos), \
            torch.from_numpy(pos.copy())
        if bt is not None:
            jb["block_tables"], tb["block_tables"] = jnp.asarray(bt), \
                torch.from_numpy(bt)
        with japi.use_policy(JXLA), japi.use_attention_policy(jattn):
            want, jcaches, _ = ref(jparams, jb, jcaches)
        with torch.no_grad(), api.use_attention_policy(attn):
            got, caches, _ = T.forward(params, cfg, tb, caches=caches)
        want = np.asarray(want[:, -1])
        np.testing.assert_allclose(got[:, -1].numpy(), want,
                                   *TOLS["float32"], err_msg=f"step {i}")
        batch = {"tokens": _greedy(want, cfg)}
        pos = np.full((B, 1), S + i, np.int32)
    assert caches[0]["len"].tolist() == [S + 3] * B


def test_engine_refuses_multi_codebook_models(model):
    _, cfg, _, params = model
    if not cfg.n_codebooks:
        eng = ServingEngine(cfg, params, ServeConfig(
            batch_slots=2, max_len=16, cache_dtype="float32", device="cpu"))
        assert eng.paged                   # internvl2 keeps the paged default
        return
    with pytest.raises(ValueError, match="n_codebooks"):
        ServingEngine(cfg, params, ServeConfig(cache_dtype="float32",
                                               device="cpu"))

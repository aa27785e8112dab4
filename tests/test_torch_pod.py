"""The pod axis (``launch/mesh.py::make_host_mesh(pod=)``, the batch over
pod x data in ``launch/steps.py``) and int8 gradient compression on
meshes that cut the params (``steps._grad_amax``,
``optim/adamw.py::quantize_int8``), against the JAX package's
single-device step on the global batch.

One spawn of four ranks over gloo; the fp32 smollm-135m and dbrx-132b
smoke configs (2 layers, vocab 64) with the JAX init:

  * on (pod 2, data 2, model 1) a ``make_train_step_fn`` step equals the
    JAX step (loss, aux, grad norm, params gathered whole) within
    ``TOLS["float32"]``; its one all-reduce over ``pod`` carries the fp32
    gradients of the rank's FSDP cuts, to the byte;
  * with ``compress_grads`` on (pod 2, data 1, model 2) and (pod 1, data
    2, model 2): a rank's cut of the JAX gradient, quantized with the
    whole leaf's amax (max-reduced over the axes that cut it), is bitwise
    the rank's cut of ``quantize_int8`` of the whole leaf; and the
    compressed step equals the JAX compressed step within the tolerance,
    or parts from it only at quantization ties (an element whose g /
    scale lies within ``TIE`` of a half-integer may round to the other
    int8 value; they are counted and printed);
  * ``launch/train.py --pod 2 --dp 2 --compress-grads`` runs.
"""
from __future__ import annotations

import torch_threads  # noqa: F401  (one intra-op thread a process)
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from parity import TOLS

import torch_mesh_ranks as R
from repro.configs.registry import get_smoke_config as jget_smoke_config
from repro.core import api as japi
from repro.core.plan import AttentionPolicy as JAttentionPolicy
from repro.core.plan import GemmPolicy as JGemmPolicy
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.convert import from_jax_params
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.launch import spawn
from repro_torch.launch.mesh import Mesh
from repro_torch.optim.adamw import quantize_int8, tree_leaves
from test_torch_expert_parallel import jax_step

ATOL, RTOL = TOLS["float32"]
DATA = dict(seq_len=16, global_batch=4, vocab=64, seed=5)
TIE = 1e-4
COMPRESSED = ("pod_ep", "data_ep")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    batch = TokenPipeline(DataConfig(**DATA)).next_batch()
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jcfgs = {a: jget_smoke_config(a, n_layers=2, vocab=64, dtype="float32")
             for a in R.POD_ARCHS}
    jparams = {a: JT.init_model(jax.random.PRNGKey(1), c)[0]
               for a, c in jcfgs.items()}
    params_np = {a: jax.tree_util.tree_map(np.asarray, p)
                 for a, p in jparams.items()}
    grads_np = {}
    for a, c in jcfgs.items():
        with japi.use_policy(JGemmPolicy(backend="xla")), \
                japi.use_attention_policy(
                    JAttentionPolicy(backend="unfused")):
            g = jax.jit(jax.grad(
                lambda p, c=c: JT.lm_loss(p, c, jbatch)[0]))(jparams[a])
        grads_np[a] = jax.tree_util.tree_map(np.asarray, g)
    tmp = tmp_path_factory.mktemp("pod")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, R.pod_rank, 4,
                            (params_np, batch, grads_np, str(tmp / "cli")),
                            workdir=str(tmp / "ranks"), timeout_s=240,
                            collective_timeout_s=60, threads=1)
        want = {(a, c): jax_step(jcfgs[a], jparams[a], batch,
                                 compress_grads=c)
                for a in jcfgs for c in (False, True)}
        ranks = ranks.result()
    return {"want": want, "init": params_np, "grads": grads_np,
            "ranks": ranks}


def _leaves(tree_np, arch):
    return [t.numpy() for t in tree_leaves(
        from_jax_params(tree_np, R.pod_config(arch)))]


@pytest.mark.parametrize("arch", R.POD_ARCHS)
def test_pod_step_matches_jax_single_device_step(run, arch):
    """(pod 2, data 2, model 1): every rank's loss, aux, grad norm and
    params equal the JAX global-batch step's; the step moved the
    weights; the pod all-reduce carries the rank's cut gradients."""
    want = run["want"][arch, False]
    jp = _leaves(want["params"], arch)
    init = _leaves(run["init"][arch], arch)
    assert max(float(np.abs(w - i).max()) for w, i in zip(jp, init)) \
        > 3 * ATOL
    closed = R.pod_all_reduce_bytes(
        R.pod_config(arch), Mesh.abstract((2, 2, 1),
                                          ("pod", "data", "model")))
    assert closed > 0
    for rk in run["ranks"]:
        got = rk[arch, "pod"]
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], atol=ATOL,
                                       rtol=RTOL, err_msg=k)
        for g, w in zip(got["params"], jp):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
        assert got["by_axes"]["all_reduce:pod"] == {"calls": 1,
                                                    "bytes": closed}


@pytest.mark.parametrize("mesh", COMPRESSED)
@pytest.mark.parametrize("arch", R.POD_ARCHS)
def test_rank_quantization_equals_the_whole_tensors_bitwise(run, arch,
                                                            mesh):
    """A rank's cut quantized with the whole tensor's amax, gathered
    whole, is bitwise the reference's ``quantize_int8`` of the whole
    tensor — a layer's leaf of the reference's stacked one — and the
    port's of a leaf outside the layers."""
    deq = jax.tree_util.tree_map(
        lambda g: np.asarray(jadamw.quantize_int8(jnp.asarray(g))[0]),
        run["grads"][arch])
    whole = _leaves(deq, arch)
    for rk in run["ranks"]:
        got = rk[arch, mesh, "quantized"]
        assert len(got) == len(whole)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g, w)
    cfg = R.pod_config(arch)
    g = from_jax_params(run["grads"][arch], cfg)["final_norm"]["scale"]
    np.testing.assert_array_equal(
        quantize_int8(g)[0].numpy(),
        from_jax_params(deq, cfg)["final_norm"]["scale"].numpy())


def _ties(g: np.ndarray) -> np.ndarray:
    """The elements of a gradient tensor (the reference's: its layers
    stacked) whose g / scale lies within TIE of a half-integer: the two
    packages may round them apart."""
    scale = np.float32(max(float(np.abs(g).max()), 1e-12) / 127.0)
    r = np.abs(g.astype(np.float32) / scale)
    return np.abs(r - np.floor(r) - 0.5) < TIE


@pytest.mark.parametrize("mesh", COMPRESSED)
@pytest.mark.parametrize("arch", R.POD_ARCHS)
def test_compressed_step_matches_jax_compressed_step(run, arch, mesh):
    """The compressed step on a mesh that cuts the params equals the JAX
    compressed step on one device: loss and grad norm within the
    tolerance, and every param within it but at quantization ties."""
    want = run["want"][arch, True]
    jp = _leaves(want["params"], arch)
    ties = _leaves(jax.tree_util.tree_map(_ties, run["grads"][arch]),
                   arch)
    for rk in run["ranks"]:
        got = rk[arch, mesh]
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], atol=ATOL,
                                       rtol=RTOL, err_msg=k)
        parted = tied = 0
        for g, w, t in zip(got["params"], jp, ties):
            off = ~np.isclose(g, w, atol=ATOL, rtol=RTOL)
            assert not (off & ~t).any(), np.argwhere(off & ~t)[:5]
            parted += int(off.sum())
            tied += int(t.sum())
        print(f"{arch} {mesh}: {parted} params parted, all at one of "
              f"{tied} ties")
    # the compressed step is another step than the plain one
    plain = _leaves(run["want"][arch, False]["params"], arch)
    assert any(not np.allclose(a, b, atol=ATOL, rtol=RTOL)
               for a, b in zip(jp, plain))


def test_train_cli_runs_on_the_pod_axis_with_compression(run):
    """``launch/train.py --pod 2 --dp 2 --compress-grads`` on four ranks
    (pod 2, data 2): two steps, a checkpoint, exit code 0."""
    assert [rk["cli"] for rk in run["ranks"]] == [0, 0, 0, 0]

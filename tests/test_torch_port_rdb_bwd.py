"""The port's RDB backward against the JAX package's Pallas backward.

On the CPU ``torchsr_tpu_torch.ops.rdb.fused_rdb`` is differentiable
through the same ``torch.autograd.Function`` that runs the CUDA kernels
on the card, here with the plain forward and the plain backward
``rdb_bwd_reference``.  The JAX side is ``jax.grad`` of
``fused_rdb(..., interpret=True)``, so its custom VJP runs the TPU
kernel ``_rdb_bwd_kernel`` in interpret mode, as tests/test_pallas_rdb.py
does.  Inputs come from numpy with a seed.  The CUDA kernel itself is
held against ``rdb_bwd_reference`` on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.models.esrgan import ResidualDenseBlock as JaxRDB
from torchsr_tpu.ops.pallas import rdb as jax_rdb
from torchsr_tpu_torch.ops import rdb as rdb_ops

# Limits are on max|port - jax| / max|jax| per gradient tensor.
# f32 on both sides, summed in other orders: measured <= 5.2e-7.
REL_F32 = 1e-5
# bf16 backward alone, both fed the same bf16 feature buffer: the same
# rounding of da to bf16 and f32 accumulation on both sides, measured
# <= 2.5e-7.
REL_BF16_SAME_FEAT = 1e-5
# bf16 end to end: the two forwards round their bf16 convolutions
# differently, and a pre-activation near 0 that rounds to the other
# sign swaps LeakyReLU' between 1 and 0.2 at that pixel, so the limit
# is on the mean instead: mean|port - jax| / mean|jax| per tensor,
# measured <= 6e-3.
MEAN_REL_BF16 = 2e-2
SHAPES = [(2, 8, 8, 64), (1, 5, 7, 64)]  # 5 x 7: ragged tiles, edges


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    params = JaxRDB().init(jax.random.PRNGKey(seed), jnp.asarray(x))
    ks = [np.array(params["params"][f"conv{i}"]["conv"]["kernel"])
          for i in range(1, 6)]
    # nonzero biases, so a pixel leaking across an image edge shows
    bs = [rng.normal(0, 0.1, (k.shape[-1],)).astype(np.float32)
          for k in ks]
    g = rng.normal(0, 1, shape).astype(np.float32)
    return x, ks, bs, g


def _jax_grads(x, ks, bs, g, dtype):
    gx, gk, gb = jax.grad(
        lambda x, ks, bs: jnp.sum(
            jax_rdb.fused_rdb(x, ks, bs, interpret=True)
            .astype(jnp.float32) * g),
        argnums=(0, 1, 2),
    )(jnp.asarray(x, dtype), [jnp.asarray(k) for k in ks],
      [jnp.asarray(b) for b in bs])
    return [np.asarray(a, np.float32) for a in (gx, *gk, *gb)]


def _port_grads(x, ks, bs, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    kt = [torch.from_numpy(k).requires_grad_() for k in ks]
    bt = [torch.from_numpy(b).requires_grad_() for b in bs]
    before = rdb_ops.RDB_BWD_LAUNCHES
    out = rdb_ops.fused_rdb(xt, kt, bt)
    grads = torch.autograd.grad(out, [xt, *kt, *bt],
                                torch.from_numpy(g).to(dtype))
    assert rdb_ops.RDB_BWD_LAUNCHES == before  # the CPU runs no kernel
    assert grads[0].dtype == dtype
    assert all(t.dtype == torch.float32 for t in grads[1:])
    return [t.float().numpy() for t in grads]


def _rel(got, want):
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_pallas_interpret_f32(shape):
    x, ks, bs, g = _inputs(shape, sum(shape))
    want = _jax_grads(x, ks, bs, g, jnp.float32)
    got = _port_grads(x, ks, bs, g, torch.float32)
    # dx, five dW (HWIO), five db
    assert [a.shape for a in got] == [b.shape for b in want]
    assert max(_rel(got, want)) <= REL_F32, _rel(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_pallas_interpret_bf16(shape):
    x, ks, bs, g = _inputs(shape, sum(shape))
    want = _jax_grads(x, ks, bs, g, jnp.bfloat16)
    got = _port_grads(x, ks, bs, g, torch.bfloat16)
    mean_rel = [float(np.abs(a - b).mean() / np.abs(b).mean())
                for a, b in zip(got, want)]
    assert max(mean_rel) <= MEAN_REL_BF16, mean_rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_on_the_same_feature_buffer(shape, dtype):
    """``rdb_bwd_reference`` against the JAX custom VJP's backward rule
    (``_fused_rdb_bwd``, the Pallas kernel in interpret mode), both fed
    the feature buffer the JAX forward saved."""
    x, ks, bs, g = _inputs(shape, sum(shape))
    jdt = jnp.dtype(dtype)
    _, residuals = jax_rdb._fused_rdb_fwd(
        jnp.asarray(x, jdt), tuple(jnp.asarray(k) for k in ks),
        tuple(jnp.asarray(b) for b in bs), 0.2, True)
    dx, dks, dbs = jax_rdb._fused_rdb_bwd(0.2, True, residuals,
                                          jnp.asarray(g, jdt))
    want = [np.asarray(a, np.float32) for a in (dx, *dks, *dbs)]
    feat = np.asarray(residuals[0].astype(jnp.float32)).reshape(
        *shape[:3], rdb_ops.FEAT)
    tdt = getattr(torch, dtype)
    got_dx, got_dw, got_db = rdb_ops.rdb_bwd_reference(
        torch.from_numpy(g).to(tdt), torch.from_numpy(feat).to(tdt),
        [torch.from_numpy(k) for k in ks], 0.2)
    got = [t.float().numpy() for t in (got_dx, *got_dw, *got_db)]
    limit = REL_F32 if dtype == "float32" else REL_BF16_SAME_FEAT
    assert max(_rel(got, want)) <= limit, _rel(got, want)


def test_plain_backward_matches_autograd_f64():
    """The plain backward is exact: against torch autograd through
    ``rdb_reference`` in f64 (measured 2.7e-15)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 5, 7, 64))).requires_grad_()
    ks = [torch.from_numpy(rng.normal(0, 0.05, (3, 3, ci, co)))
          .requires_grad_() for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    bs = [torch.from_numpy(rng.normal(0, 0.1, (co,))).requires_grad_()
          for co in rdb_ops.COUT]
    g = torch.from_numpy(rng.normal(0, 1, (2, 5, 7, 64)))
    want = torch.autograd.grad(rdb_ops.rdb_reference(x, ks, bs),
                               [x, *ks, *bs], g)
    got = torch.autograd.grad(rdb_ops.fused_rdb(x, ks, bs), [x, *ks, *bs], g)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_module_gradients_reach_the_f32_parameters():
    """A block of the generator trains through the Function: its conv
    parameters (OIHW, f32) get f32 gradients equal to autograd through
    the plain block."""
    from torchsr_tpu_torch.models.esrgan import ResidualDenseBlock

    rdb = ResidualDenseBlock()
    gen = torch.Generator().manual_seed(2)
    for conv in rdb.convs():
        conv.reset_parameters(gen)
    x = torch.randn((2, 6, 5, 64), generator=gen)
    params = [p for c in rdb.convs() for p in (c.weight, c.bias)]
    got = torch.autograd.grad(rdb(x).square().sum(), params)
    convs = rdb.convs()
    ref = rdb_ops.rdb_reference(
        x, [c.weight.permute(2, 3, 1, 0) for c in convs],
        [c.bias for c in convs])
    want = torch.autograd.grad(ref.square().sum(), params)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_backward_kernel_path_refuses_cpu_tensors():
    x, ks, _, g = _inputs((1, 4, 4, 64), 1)
    feat = torch.zeros((1, 4, 4, rdb_ops.FEAT))
    with pytest.raises(ValueError, match="CUDA"):
        rdb_ops.rdb_bwd_cuda(torch.from_numpy(g), feat,
                             [torch.from_numpy(k) for k in ks])


@pytest.mark.parametrize("bad", ["g_shape", "feat_width", "kernel_shape"])
def test_backward_rejects_malformed_inputs(bad):
    x, ks, _, g = _inputs((1, 4, 4, 64), 1)
    feat = torch.zeros((1, 4, 4, rdb_ops.FEAT))
    g, ks = torch.from_numpy(g), [torch.from_numpy(k) for k in ks]
    if bad == "g_shape":
        g = g[:, :3]
    elif bad == "feat_width":
        feat = feat[..., :128]
    else:
        ks[1] = ks[1][:, :, :64]
    with pytest.raises(ValueError):
        rdb_ops.rdb_bwd_reference(g, feat, ks) if bad != "kernel_shape" \
            else rdb_ops.rdb_bwd_cuda(g, feat, ks)


def _dy_reference_grads(x, ks, bs, g, dtype, padded=False):
    """The port's plain forward, then ``rdb_bwd_dy_reference`` (the data
    flow of the bf16 backward kernels) on its feature buffer."""
    kt = [torch.from_numpy(k) for k in ks]
    xt = torch.from_numpy(x).to(dtype)
    if padded:
        _, feat = rdb_ops.rdb_ext_reference(xt, kt, [torch.from_numpy(b)
                                                     for b in bs])
    else:
        _, feat = rdb_ops._rdb_plain(xt, kt, [torch.from_numpy(b)
                                              for b in bs], 0.2)
    dx, dws, dbs, dy = rdb_ops.rdb_bwd_dy_reference(
        torch.from_numpy(g).to(dtype), feat, kt, 0.2, padded=padded)
    assert dx.dtype == dtype and dy.dtype == dtype
    assert dy.shape == (*feat.shape[:3], rdb_ops.FEAT)
    assert all(t.dtype == torch.float32 for t in (*dws, *dbs))
    return [t.float().numpy() for t in (dx, *dws, *dbs)], feat, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dy_reference_matches_pallas_interpret(shape, dtype):
    """``rdb_bwd_dy_reference`` against the JAX package's block gradient
    (``fused_rdb`` under ``jax.grad``, the Pallas kernels in interpret
    mode): f32 per tensor within REL_F32, bf16 in the mean within
    MEAN_REL_BF16 (the two forwards round differently)."""
    x, ks, bs, g = _inputs(shape, sum(shape))
    want = _jax_grads(x, ks, bs, g, jnp.dtype(dtype))
    got, _, _ = _dy_reference_grads(x, ks, bs, g, getattr(torch, dtype))
    assert [a.shape for a in got] == [b.shape for b in want]
    if dtype == "float32":
        assert max(_rel(got, want)) <= REL_F32, _rel(got, want)
    else:
        mean_rel = [float(np.abs(a - b).mean() / np.abs(b).mean())
                    for a, b in zip(got, want)]
        assert max(mean_rel) <= MEAN_REL_BF16, mean_rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dy_reference_ext_form_matches_ext_reference(dtype):
    """The padded form of ``rdb_bwd_dy_reference`` (DY in the (B, H + 2,
    W, 192) layout, pad rows zero) against ``rdb_bwd_ext_reference`` on
    the same row-extended buffer, and equal to the unpadded form on its
    data rows."""
    shape = (2, 6, 16, 64)
    x, ks, bs, g = _inputs(shape, 3)
    tdt = getattr(torch, dtype)
    got, featp, dyp = _dy_reference_grads(x, ks, bs, g, tdt, padded=True)
    assert featp.shape == (2, 8, 16, rdb_ops.FEAT)
    assert not dyp[:, [0, -1]].any()
    kt = [torch.from_numpy(k) for k in ks]
    dx, dws, dbs = rdb_ops.rdb_bwd_ext_reference(
        torch.from_numpy(g).to(tdt), featp, kt, 0.2)
    want = [t.float().numpy() for t in (dx, *dws, *dbs)]
    if dtype == "float32":
        assert max(_rel(got, want)) <= REL_F32, _rel(got, want)
    else:
        mean_rel = [float(np.abs(a - b).mean() / np.abs(b).mean())
                    for a, b in zip(got, want)]
        assert max(mean_rel) <= MEAN_REL_BF16, mean_rel
    flat = rdb_ops.rdb_bwd_dy_reference(torch.from_numpy(g).to(tdt),
                                        featp[:, 1:-1], kt, 0.2)
    assert torch.equal(flat[3], dyp[:, 1:-1])


@pytest.mark.parametrize("shape", [(64, 32, 32), (3, 37, 45), (2, 3, 130),
                                   (1, 63, 63)], ids=str)
def test_bwd_schedule_covers_every_pixel_and_slot_once(shape):
    """The mirror of the bf16 backward's persistent schedule: every slot
    conv (dx's two halves included) takes every (run, K chunk) item
    once, the runs cover every pixel of every image once, every run's
    halo fits a stage, and each kernel's stages fit the H100's shared
    memory."""
    from torchsr_tpu_torch.ops.pair_conv import conv_runs

    b, h, w = shape
    runs = conv_runs(b, h, w)
    sched = rdb_ops.bwd_schedule(b, h, w)
    assert sched["runs"] == len(runs)
    covered = np.zeros((b, h * w), dtype=np.int64)
    for img, p0, n in runs:
        covered[img, p0:p0 + n] += 1
        assert n <= rdb_ops._BWD_RUN
        rows = (p0 + n - 1) // w - p0 // w + 3
        halo_w = w + 2 if w <= rdb_ops._BWD_NARROW_W else n + 2
        assert rows * halo_w <= rdb_ops._BWD_HALO_MAX
    assert (covered == 1).all()
    for slot in range(6):
        walks = rdb_ops.bwd_walk(b, h, w, slot)
        items = [it for walk in walks for it in walk]
        nch = rdb_ops._BWD_SLOT_CHUNKS[slot]
        assert sorted(items) == [(t, c) for t in range(len(runs))
                                 for c in range(nch)]
        assert len(walks) <= rdb_ops._BWD_CTAS // (1 if slot < 4 else 2)
    assert sched["wgrad_ctas"] * rdb_ops._BWD_WGRAD_TILES <= rdb_ops._BWD_CTAS
    assert rdb_ops._BWD_CONV_SMEM <= rdb_ops.SMEM_LIMIT
    assert rdb_ops._BWD_WGRAD_SMEM <= rdb_ops.SMEM_LIMIT
    # the K chunks of slot s cover the DY suffix it reads, in 64s
    for s, k0 in enumerate(rdb_ops._BWD_SLOT_K0):
        assert 64 * (rdb_ops._BWD_SLOT_CHUNKS[s] - 1) < rdb_ops.FEAT - k0 \
            <= 64 * rdb_ops._BWD_SLOT_CHUNKS[s]


# The f32 backward (3xTF32, csrc/rdb_bwd_tf32_sm90.cuh): its arithmetic
# in plain PyTorch (``rdb_bwd_3xtf32_reference``) held as chip_smoke.py
# holds the kernel's whole backward, per element: |got - ref| <= rel
# |ref| + frac max|ref| with chip_smoke.py's BWD_BLOCK_LIMITS[f32].
BWD_BLOCK_LIMITS_F32 = (1e-4, 1e-4)


def _excess(got, ref, limits=BWD_BLOCK_LIMITS_F32) -> float:
    rel, frac = limits
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    bound = rel * np.abs(ref) + frac * np.abs(ref).max()
    return float(np.where(diff == 0, 0.0, diff / bound).max())


def _ref_cotangents(g, feat, kernels, dfeat):
    """The cotangents [dy_0 | ... | dy_4] (B, H, W, 192) of the plain
    backward: its dense gradient's slots times LeakyReLU', then scale
    g."""
    dys = [dfeat[..., rdb_ops._slot(j)] * (
        0.2 + 0.8 * (feat[..., rdb_ops._slot(j)] > 0).float())
        for j in range(4)]
    return torch.cat([*dys, g * 0.2], dim=-1)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_3xtf32_backward_matches_pallas_interpret(shape):
    """``rdb_bwd_3xtf32_reference`` on the feature buffer the JAX
    forward saved against the JAX custom VJP's backward rule (the Pallas
    kernel ``_rdb_bwd_kernel`` in interpret mode, f32): dx, each dW and
    db within BWD_BLOCK_LIMITS_F32; its DY against the cotangents of the
    plain backward on the same buffer."""
    x, ks, bs, g = _inputs(shape, sum(shape))
    _, residuals = jax_rdb._fused_rdb_fwd(
        jnp.asarray(x), tuple(jnp.asarray(k) for k in ks),
        tuple(jnp.asarray(b) for b in bs), 0.2, True)
    dx, dks, dbs = jax_rdb._fused_rdb_bwd(0.2, True, residuals,
                                          jnp.asarray(g))
    want = [np.asarray(a, np.float32) for a in (dx, *dks, *dbs)]
    feat = torch.from_numpy(np.array(residuals[0]).reshape(
        *shape[:3], rdb_ops.FEAT))
    kt, gt = [torch.from_numpy(k) for k in ks], torch.from_numpy(g)
    got_dx, got_dw, got_db, got_dy = rdb_ops.rdb_bwd_3xtf32_reference(
        gt, feat, kt, 0.2)
    got = [t.numpy() for t in (got_dx, *got_dw, *got_db)]
    assert [a.shape for a in got] == [b.shape for b in want]
    assert max(_excess(a, b) for a, b in zip(got, want)) <= 1
    ref = rdb_ops.rdb_bwd_reference(gt, feat, kt, 0.2, return_dfeat=True)
    assert _excess(got_dy, _ref_cotangents(gt, feat, kt, ref[3])) <= 1


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_3xtf32_backward_matches_plain_backward(shape):
    """The same reference against ``rdb_bwd_reference`` in f32 on the
    port's own feature buffer: dx, dW, db and DY within the limits; plain
    TF32 (one product) reads over them."""
    x, ks, bs, g = _inputs(shape, sum(shape) + 1)
    kt = [torch.from_numpy(k) for k in ks]
    _, feat = rdb_ops._rdb_plain(torch.from_numpy(x), kt,
                                 [torch.from_numpy(b) for b in bs], 0.2)
    gt = torch.from_numpy(g)
    ref = rdb_ops.rdb_bwd_reference(gt, feat, kt, 0.2, return_dfeat=True)
    ref_dy = _ref_cotangents(gt, feat, kt, ref[3])

    def worst(got):
        return max(_excess(got[0], ref[0]), _excess(got[3], ref_dy),
                   *(_excess(a, b) for a, b in zip(got[1], ref[1])),
                   *(_excess(a, b) for a, b in zip(got[2], ref[2])))

    got = rdb_ops.rdb_bwd_3xtf32_reference(gt, feat, kt, 0.2)
    assert all(t.dtype == torch.float32 for t in (got[0], *got[1], *got[2],
                                                   got[3]))
    assert worst(got) <= 1
    once = rdb_ops.rdb_bwd_3xtf32_reference(gt, feat, kt, 0.2,
                                            terms=(("hi", "hi"),))
    assert worst(once) > 1


def test_3xtf32_padded_form_matches_the_ext_reference():
    """The padded form (feat and DY in the (B, H + 2, W, 192) layout, DY's
    pad rows zero) against ``rdb_bwd_ext_reference`` on the same
    row-extended buffer, and equal to the unpadded form on its data
    rows."""
    shape = (2, 6, 16, 64)
    x, ks, bs, g = _inputs(shape, 3)
    kt, gt = [torch.from_numpy(k) for k in ks], torch.from_numpy(g)
    _, featp = rdb_ops.rdb_ext_reference(torch.from_numpy(x), kt,
                                         [torch.from_numpy(b) for b in bs])
    dx, dws, dbs, dyp = rdb_ops.rdb_bwd_3xtf32_reference(gt, featp, kt, 0.2,
                                                         padded=True)
    assert dyp.shape == featp.shape and not dyp[:, [0, -1]].any()
    want = rdb_ops.rdb_bwd_ext_reference(gt, featp, kt, 0.2)
    got = (dx, *dws, *dbs)
    assert max(_excess(a, b) for a, b in zip(
        got, (want[0], *want[1], *want[2]))) <= 1
    flat = rdb_ops.rdb_bwd_3xtf32_reference(gt, featp[:, 1:-1], kt, 0.2)
    assert all(torch.equal(a, b) for a, b in zip(
        (flat[0], *flat[1], *flat[2], flat[3]), (*got, dyp[:, 1:-1])))


@pytest.mark.parametrize("shape", [(64, 32, 32), (3, 37, 45), (2, 3, 130),
                                   (1, 63, 63)], ids=str)
def test_bwd_tf32_schedule_covers_every_pixel_and_slot_once(shape):
    """The mirror of the f32 backward's schedule: every slot conv (dx's
    two halves included) takes every (run, K chunk) item once, its runs
    (the f32 forward's) cover every pixel once; every wgrad tile's CTAs
    and ky take every run once (one wave of CTAs); the K chunks of each
    slot cover the DY suffix it reads; each kernel's shared memory fits
    the H100's."""
    b, h, w = shape
    sched = rdb_ops.bwd_tf32_schedule(b, h, w)
    runs = rdb_ops.fwd_runs(b, h, w, rdb_ops._FWD_TF32_WIDE_M)
    assert sched["runs"] == len(runs)
    covered = np.zeros((b, h * w), dtype=np.int64)
    for img, p0, n, *_ in runs:
        covered[img, p0:p0 + n] += 1
        assert n <= 128
    assert (covered == 1).all()
    for slot in range(6):
        walks = rdb_ops.bwd_tf32_walk(b, h, w, slot)
        items = sorted(it for walk in walks for it in walk)
        nch = rdb_ops._BWD_TF32_SLOT_CHUNKS[slot]
        assert items == [(t, c) for t in range(len(runs))
                         for c in range(nch)]
        assert 32 * nch == rdb_ops.FEAT - rdb_ops._BWD_SLOT_K0[slot]
        assert len(walks) == sched["conv_ctas" if slot < 4 else "dx_ctas"]
    ctas = sched["wgrad_ctas"]
    assert sorted(t for c in range(ctas)
                  for t in range(c, len(runs), ctas)) == list(
        range(len(runs)))
    assert 3 * ctas * rdb_ops._BWD_WGRAD_TILES <= rdb_ops._BWD_CTAS
    assert sched["smem"] <= rdb_ops.SMEM_LIMIT - 4352
    assert sched["wgrad_smem"] <= rdb_ops.SMEM_LIMIT
    assert sched["prep_blocks"] * rdb_ops._BWD_TF32_PREP_PIXELS >= b * h * w


@pytest.mark.parametrize("layout", ["f32_views", "f32_contiguous"])
def test_bwd_tf32_weight_packing_round_trips(layout):
    """The f32 backward prep's planes (``bwd_tf32_pack_weights``, the
    flipped, transposed kernels as TF32 hi and lo planes) unpack to the
    caller's kernels exactly, from contiguous HWIO kernels or the HWIO
    views of OIHW parameters the trainer hands over; every hi holds only
    TF32 bits, and hi + lo is the weight."""
    rng = np.random.default_rng(7)
    ks = [torch.from_numpy(rng.normal(0, 0.05, (3, 3, ci, co))
                           .astype(np.float32))
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    if layout == "f32_views":
        ks = [k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
              for k in ks]
    packed = rdb_ops.bwd_tf32_pack_weights(ks)
    assert packed.numel() == rdb_ops._BWD_TF32_WPACK
    planes = packed.view(-1, 2, 3 * rdb_ops.GROWTH * 32)
    assert not (planes[:, 0].view(torch.int32) & 0x1FFF).any()
    back = rdb_ops.bwd_tf32_unpack_weights(packed)
    assert all(torch.equal(a, b) for a, b in zip(back, ks))


@pytest.mark.parametrize("entry", ["rdb_bwd_cuda", "rdb_bwd_ext_cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_counts_its_launches_by_dtype(monkeypatch, entry, dtype):
    """A backward call adds one to its own dtype's counter (f32: the
    3xTF32 kernels' ``RDB_BWD*_F32_LAUNCHES``) and to no other.  The
    launch itself is stubbed: the CPU has no kernel."""
    monkeypatch.setattr(rdb_ops, "_cuda_operands", lambda *a: None)
    monkeypatch.setattr(rdb_ops, "_bwd_launches", lambda *a: None)
    for name in rdb_ops.LAUNCH_COUNTERS:
        monkeypatch.setattr(rdb_ops, name, 0)
    dt = getattr(torch, dtype)
    ext = entry == "rdb_bwd_ext_cuda"
    feat = torch.zeros((1, 4 if ext else 2, 16, rdb_ops.FEAT), dtype=dt)
    g = torch.zeros((1, 2, 16, 64), dtype=dt)
    ks = [torch.zeros((3, 3, ci, co), dtype=dt)
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    getattr(rdb_ops, entry)(g, feat, ks)
    tag = "_EXT" if ext else ""
    want = f"RDB_BWD{tag}_F32_LAUNCHES" if dt == torch.float32 else \
        f"RDB_BWD{tag}_LAUNCHES"
    assert {n: getattr(rdb_ops, n) for n in rdb_ops.LAUNCH_COUNTERS} == {
        n: 1 if n == want else 0 for n in rdb_ops.LAUNCH_COUNTERS}


def test_backward_refuses_too_many_pixels(monkeypatch):
    """The kernels count a call's buffer pixels in 32-bit ints: a call
    over that many is refused before any launch (the shape check reads
    the shape only)."""
    monkeypatch.setattr(rdb_ops, "_cuda_operands", lambda *a: None)
    monkeypatch.setattr(rdb_ops, "_bwd_launches", lambda *a: pytest.fail(
        "launched"))
    b = rdb_ops._MAX_BWD_PIXELS // (64 * 64) + 1
    feat = torch.zeros((1, 1, 1, rdb_ops.FEAT)).expand(b, 64, 64, -1)
    g = torch.zeros((1, 1, 1, 64)).expand(b, 64, 64, -1)
    ks = [torch.zeros((3, 3, ci, co))
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    with pytest.raises(ValueError, match="buffer pixels"):
        rdb_ops.rdb_bwd_cuda(g, feat, ks)

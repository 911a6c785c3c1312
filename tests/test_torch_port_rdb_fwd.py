"""The plain version of the bf16 RDB forward kernels' data flow.

``ops/rdb.py`` ``rdb_fwd_kxpack_reference`` is the data flow of
``csrc/rdb_fwd_sm90.cuh`` (B1 and B7 on the card): per conv and vertical
tap one product with the three horizontal taps packed along N, the taps
reduced on the results with the column masks.  Here it is held against
the JAX package's ``_rdb_fwd`` (the Pallas kernels in interpret mode, as
tests/test_pallas_rdb.py runs them), against the row-extended kernel
with the knob set, and against ``rdb_reference``; the mirror of the
kernels' run schedule (``fwd_runs``, ``fwd_schedule``, ``fwd_walk``) and
of their weight packing (``fwd_pack_weights``) are checked for
coverage.  The f32 kernels' arithmetic (3xTF32, ``csrc/
rdb_fwd_tf32_sm90.cuh``), ``rdb_fwd_3xtf32_reference``, is held the same
way in f32 (its padded form against the row-extended one), with the
mirrors of its schedule (``fwd_tf32_schedule``, ``fwd_tf32_walk``) and
of its prep's split weight planes (``fwd_tf32_pack_weights``).  Inputs
come from numpy with a seed.  The CUDA kernels themselves are held
against these on the card by chip_smoke.py.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.models.esrgan import ResidualDenseBlock as JaxRDB
from torchsr_tpu.ops.pallas import rdb as jax_rdb
from torchsr_tpu_torch.ops import rdb as rdb_ops

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# f32 on both sides, summed in other orders: measured <= 1.2e-7.
ATOL_F32 = 1e-5
# bf16: the two sides round a sum at a tie the other way now and then
# (measured: one bf16 step, 2^-9 of 2.4, on the ragged shape); held to
# chip_smoke.py's block limits (rel 2^-7, frac 2^-5 of the largest value
# the block adds) on the output and the feature buffer.
LIMITS_BF16 = smoke.BLOCK_LIMITS[torch.bfloat16]
# The f32 kernels' 3xTF32 arithmetic against f32 sums of the same f32
# operands: chip_smoke.py's f32 limits, each launch's (1e-5 of the value
# plus 1e-5 of the launch's largest output) on the feature buffer's grown
# slices and the block's (1e-5, 1e-4 of the largest residual) on the
# output.
STAGE_F32 = smoke.STAGE_LIMITS[torch.float32]
BLOCK_F32 = smoke.BLOCK_LIMITS[torch.float32]
# W = 1, H = 1, a ragged shape whose runs cross row ends mid-row, and a
# row-crossing W = 32 (several images)
SHAPES = [(2, 5, 1, 64), (2, 1, 7, 64), (3, 37, 45, 64), (2, 9, 32, 64)]
# The row-extended kernel's gate (H * W <= 4096, W % 16 == 0): H = 1, a
# row-crossing W = 32, and a ragged height
EXT_SHAPES = [(2, 1, 16, 64), (2, 9, 32, 64), (3, 37, 48, 64)]
DTYPES = ["float32", "bfloat16"]


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
    ks = [np.asarray(params["params"][f"conv{i}"]["conv"]["kernel"])
          for i in range(1, 6)]
    # nonzero biases, so a pixel leaking across an image edge shows
    bs = [rng.normal(0, 0.1, (k.shape[-1],)).astype(np.float32)
          for k in ks]
    return x, ks, bs


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_fwd(x, ks, bs, dtype):
    """The JAX forward that saves its feature buffer (``_rdb_fwd`` with
    ``save_feat``, the Pallas kernel in interpret mode): out, feat."""
    out, res = jax_rdb._fused_rdb_fwd(
        jnp.asarray(x, dtype), tuple(jnp.asarray(k) for k in ks),
        tuple(jnp.asarray(b) for b in bs), 0.2, True)
    return (np.array(out.astype(jnp.float32)),
            np.array(res[0].astype(jnp.float32)).reshape(
                *x.shape[:3], rdb_ops.FEAT))


def _held(got, want, x, dtype):
    """Out and feat of the port against the JAX package's."""
    out, feat = (t.float().numpy() for t in got)
    if dtype == "float32":
        np.testing.assert_allclose(out, want[0], rtol=0, atol=ATOL_F32)
        np.testing.assert_allclose(feat, want[1], rtol=0, atol=ATOL_F32)
    else:
        xt = torch.from_numpy(x)
        assert smoke.excess(torch.from_numpy(out), torch.from_numpy(want[0]),
                            LIMITS_BF16, xt) <= 1
        assert smoke.excess(torch.from_numpy(feat),
                            torch.from_numpy(want[1]), LIMITS_BF16) <= 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kxpack_reference_matches_pallas_interpret(shape, dtype):
    x, ks, bs = _inputs(shape, sum(shape))
    want = _jax_fwd(x, ks, bs, jnp.dtype(dtype))
    got = rdb_ops.rdb_fwd_kxpack_reference(
        torch.from_numpy(x).to(getattr(torch, dtype)), _t(ks), _t(bs))
    assert got[0].shape == x.shape and got[1].shape == (*shape[:3], 192)
    assert got[0].dtype == got[1].dtype == getattr(torch, dtype)
    _held(got, want, x, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", EXT_SHAPES, ids=str)
def test_kxpack_padded_matches_the_ext_kernel(shape, dtype):
    """The padded form (``rdb_ext_reference``) against the JAX
    row-extended kernel (``_rdb_fwd_kernel_ext``, the knob set): the data
    rows are its saved buffer, the pad rows zero; and the same as the
    unpadded form."""
    x, ks, bs = _inputs(shape, sum(shape) + 1)
    saved = [(m, getattr(m, "EXT_KERNEL")) for m in (jax_rdb, rdb_ops)]
    try:
        for m, _ in saved:
            m.EXT_KERNEL = True
        jax.clear_caches()
        assert jax_rdb._ext_eligible(shape[1] * shape[2], shape[2])
        want = _jax_fwd(x, ks, bs, jnp.dtype(dtype))
    finally:
        for m, v in saved:
            m.EXT_KERNEL = v
        jax.clear_caches()
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out, featp = rdb_ops.rdb_ext_reference(xt, _t(ks), _t(bs))
    assert featp.shape == (shape[0], shape[1] + 2, shape[2], 192)
    assert not featp[:, 0].any() and not featp[:, -1].any()
    _held((out, featp[:, 1:-1]), want, x, dtype)
    flat = rdb_ops.rdb_fwd_kxpack_reference(xt, _t(ks), _t(bs))
    assert torch.equal(flat[0], out) and torch.equal(flat[1], featp[:, 1:-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kxpack_reference_matches_rdb_reference(shape, dtype):
    """Against the five ``F.conv2d`` of ``rdb_reference`` (and its feature
    buffer), the same products summed in another order."""
    x, ks, bs = _inputs(shape, sum(shape) + 2)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    got = rdb_ops.rdb_fwd_kxpack_reference(xt, _t(ks), _t(bs))
    if dtype == "float32":
        want = rdb_ops._rdb_plain(xt, _t(ks), _t(bs), 0.2)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL_F32)
    else:
        # the plain path computes in bf16; hold both to the f32 sums of
        # the same bf16 operands, launch by launch as chip_smoke does
        row = smoke.rdb_scores(xt, [k.to(tdt) for k in _t(ks)], _t(bs),
                               *got)
        assert max(row["stage_excess"]) <= 1, row
        assert row["block_excess"] <= 1, row


@pytest.mark.parametrize("shape", [(2, 7, 1), (1, 70, 2), (3, 37, 45),
                                   (2, 9, 64), (1, 3, 140), (1, 2, 480),
                                   (16, 64, 64), (64, 32, 32)], ids=str)
def test_fwd_schedule_covers_every_pixel_once(shape):
    """The mirror of the bf16 forward's persistent schedule: the runs
    cover every output pixel of every image once; each run's y rows (its
    pixels, and inside a row one beyond each end) read, for each ky, the
    pixel of its halo box that holds the image pixel one row up or down;
    every slot's walk takes every (run, K chunk) once, chunk 0 last; each
    conv's ring has two stages at least, each holding a box, and fits the
    H100's shared memory beside its weights and output tile."""
    b, h, w = shape
    runs = rdb_ops.fwd_runs(b, h, w)
    sched = rdb_ops.fwd_schedule(b, h, w)
    bw, bh = sched["box"]
    assert sched["runs"] == len(runs)
    assert bw <= 256 and bh <= 256  # a TMA box's dimensions
    assert bw * bh * 128 <= sched["stage_bytes"]
    assert sched["stage_bytes"] % 1024 == 0
    covered = np.zeros((b, h * w), dtype=np.int64)
    for img, p0, n, e, r0, hx0, hw in runs:
        assert 1 <= n and n + 2 * e <= rdb_ops._FWD_M and hw == bw
        covered[img, p0:p0 + n] += 1
        if w <= rdb_ops._FWD_NARROW_W:  # whole rows, no extension
            assert e == 0 and p0 % w == 0 and n % w == 0 and n // w <= bh - 2
        else:  # inside one row
            assert e == 1 and (p0 % w) + n <= w and n + 2 <= bw and bh == 3
        for m in range(n + 2 * e):
            q = p0 - e + m  # y row m's pixel, in image order
            qy, qx = (q // w, q % w) if e == 0 else (p0 // w, p0 % w - 1 + m)
            for ky in range(3):
                hr, hc = divmod(m + ky * hw, hw)
                assert hr < bh
                assert (r0 - 1 + hr, hx0 + hc) == (qy + ky - 1, qx)
    assert (covered == 1).all()
    for slot in range(6):
        walks = rdb_ops.fwd_walk(b, h, w, slot)
        items = [it for walk in walks for it in walk]
        nch = rdb_ops._FWD_SLOT_CHUNKS[slot]
        assert sorted(items) == [(t, c) for t in range(len(runs))
                                 for c in range(nch)]
        assert all(walk[-1][1] == 0 for walk in walks if walk)
        assert len(walks) <= rdb_ops._FWD_CTAS // (1 if slot < 4 else 2)
        assert 2 <= sched["stages"][slot] <= rdb_ops._FWD_MAX_STAGES
        assert sched["smem"][slot] <= rdb_ops._FWD_SMEM_DYN
    # the K chunks of slot s cover its C_in in 64s
    for s, nch in enumerate(rdb_ops._FWD_SLOT_CHUNKS):
        cin = rdb_ops.CIN[min(s, 4)]
        assert 64 * (nch - 1) < cin <= 64 * nch


def _hwio(seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 0.05, (3, 3, ci, co)).astype(
        np.float32)).to(dtype) for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]


@pytest.mark.parametrize("layout", ["f32_views", "bf16_contiguous"])
def test_fwd_weight_packing_round_trips(layout):
    """``fwd_unpack_weights(fwd_pack_weights(k)) == k`` rounded to bf16,
    from f32 HWIO views of OIHW tensors (the trainer's parameters) and
    from bf16 contiguous kernels; the packed buffer has the kernels'
    size, zeros past each conv's C_in, and the layout the prep launch
    writes: slot s, chunk c, ky, row kx * 32 + co, column k."""
    ks = _hwio(5)
    if layout == "f32_views":
        ks = [k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
              for k in ks]
        assert not ks[0].is_contiguous()
    else:
        ks = [k.to(torch.bfloat16) for k in ks]
    packed = rdb_ops.fwd_pack_weights(ks)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (rdb_ops._FWD_WPACK,)
    back = rdb_ops.fwd_unpack_weights(packed)
    for a, k in zip(back, ks):
        assert torch.equal(a, k.to(torch.bfloat16))
    # conv 2 (slot 1), chunk 1 holds channels 64-95, then zeros
    seg = packed[18432:18432 + 2 * 18432].view(2, 3, 96, 64)
    assert not seg[1, :, :, 32:].any()
    k2 = ks[1].to(torch.bfloat16)
    assert torch.equal(seg[1, 2, 3 * 0 + 5, :32], k2[2, 0, 64:96, 5])
    assert torch.equal(seg[0, 1, 32 * 2 + 7, :], k2[1, 2, :64, 7])
    # conv 5's second half (slot 5) holds output channels 32-63
    seg5 = packed[-3 * 18432:].view(3, 3, 96, 64)
    assert torch.equal(seg5[2, 0, 32 + 1, :], ks[4].to(torch.bfloat16)[
        0, 1, 128:192, 33])


def _held_f32(out, feat, want_out, want_feat, x):
    """An f32 block (output and (B, H, W, 192) buffer) against another
    one under chip_smoke.py's f32 limits: x bit for bit, each grown slice
    under the launch limit, the output under the block limit."""
    assert torch.equal(feat[..., :64], want_feat[..., :64])
    for i in range(4):
        sl = slice(64 + 32 * i, 96 + 32 * i)
        assert smoke.excess(feat[..., sl], want_feat[..., sl],
                            STAGE_F32) <= 1, i
    assert smoke.excess(out, want_out, BLOCK_F32, x) <= 1


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_3xtf32_reference_matches_pallas_interpret(shape):
    """The f32 kernels' arithmetic against the JAX package's f32
    ``_rdb_fwd`` (Pallas interpret mode), output and feature buffer."""
    x, ks, bs = _inputs(shape, sum(shape) + 3)
    want = _jax_fwd(x, ks, bs, jnp.float32)
    out, feat = rdb_ops.rdb_fwd_3xtf32_reference(torch.from_numpy(x),
                                                 _t(ks), _t(bs))
    assert out.dtype == feat.dtype == torch.float32
    assert feat.shape == (*shape[:3], 192)
    _held_f32(out, feat, *_t(want), torch.from_numpy(x))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_3xtf32_reference_matches_rdb_reference(shape):
    """Against the five f32 ``F.conv2d`` of ``rdb_reference``: within the
    limits launch by launch (each against its own conv of the buffer it
    filled, as chip_smoke.py holds the kernel) and for the block; plain
    TF32 and 3xTF32 short of lo.hi read over the launch limit (the block
    limit, on chip_smoke.py's weights: tests/test_torch_port_smoke.py)."""
    x, ks, bs = _inputs(shape, sum(shape) + 4)
    xt = torch.from_numpy(x)
    out, feat = rdb_ops.rdb_fwd_3xtf32_reference(xt, _t(ks), _t(bs))
    _held_f32(out, feat, *rdb_ops._rdb_plain(xt, _t(ks), _t(bs), 0.2), xt)
    row = smoke.rdb_scores(xt, _t(ks), _t(bs), out, feat)
    assert max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1, row
    wrong = smoke.tf32_wrong_excess(xt, _t(ks), _t(bs))
    assert set(wrong) == set(smoke.WRONG_PAIR_TF32)
    assert min(r["stage"] for r in wrong.values()) > 1, wrong


@pytest.mark.parametrize("shape", EXT_SHAPES, ids=str)
def test_3xtf32_padded_form_matches_the_ext_reference(shape):
    """The padded form (B7's buffer): zero pad rows, its data rows the
    unpadded form's bit for bit (B7 equals B1), and within the f32
    limits of ``rdb_ext_reference``, the row-extended plain version."""
    x, ks, bs = _inputs(shape, sum(shape) + 5)
    xt = torch.from_numpy(x)
    out, featp = rdb_ops.rdb_fwd_3xtf32_reference(xt, _t(ks), _t(bs),
                                                  padded=True)
    assert featp.shape == (shape[0], shape[1] + 2, shape[2], 192)
    assert not featp[:, 0].any() and not featp[:, -1].any()
    flat = rdb_ops.rdb_fwd_3xtf32_reference(xt, _t(ks), _t(bs))
    assert torch.equal(flat[0], out) and torch.equal(flat[1],
                                                     featp[:, 1:-1])
    want_out, want_featp = rdb_ops.rdb_ext_reference(xt, _t(ks), _t(bs))
    _held_f32(out, featp[:, 1:-1], want_out, want_featp[:, 1:-1], xt)


@pytest.mark.parametrize("shape", [(2, 7, 1), (1, 70, 2), (3, 37, 45),
                                   (2, 9, 64), (1, 3, 140), (1, 2, 480),
                                   (1, 44, 44), (16, 64, 64), (64, 32, 32)],
                         ids=str)
def test_fwd_tf32_schedule_covers_every_pixel_once(shape):
    """The mirror of the f32 forward's persistent schedule: the runs
    cover every output pixel of every image once, inside a row at most
    ``_FWD_TF32_WIDE_M`` y rows; each y row reads, for each ky, the box
    pixel that holds the image pixel one row up or down; every slot's
    walk takes every (run, K chunk of 32 channels) once, chunk 0 first;
    the ring holds two items at least (a halo box and a chunk's planes
    each) within the H100's shared memory."""
    b, h, w = shape
    wide_m = rdb_ops._FWD_TF32_WIDE_M
    runs = rdb_ops.fwd_runs(b, h, w, wide_m)
    sched = rdb_ops.fwd_tf32_schedule(b, h, w)
    bw, bh = sched["box"]
    assert sched["runs"] == len(runs)
    assert bw <= 256 and bh <= 256  # a TMA box's dimensions
    assert bw * bh * 128 <= sched["halo_bytes"]
    assert sched["halo_bytes"] % 1024 == 0
    assert sched["stage_bytes"] == (sched["halo_bytes"]
                                    + rdb_ops._FWD_TF32_W_CHUNK)
    assert 2 <= sched["stages"] <= rdb_ops._FWD_MAX_STAGES
    assert sched["smem"] <= rdb_ops._FWD_SMEM_DYN
    covered = np.zeros((b, h * w), dtype=np.int64)
    for img, p0, n, e, r0, hx0, hw in runs:
        assert hw == bw
        covered[img, p0:p0 + n] += 1
        if w <= rdb_ops._FWD_NARROW_W:
            assert e == 0 and p0 % w == 0 and n <= rdb_ops._FWD_M
        else:
            assert e == 1 and (p0 % w) + n <= w and n + 2 <= wide_m
            assert bh == 3
        for m in range(n + 2 * e):
            q = p0 - e + m
            qy, qx = (q // w, q % w) if e == 0 else (p0 // w, p0 % w - 1 + m)
            for ky in range(3):
                hr, hc = divmod(m + ky * hw, hw)
                assert hr < bh
                assert (r0 - 1 + hr, hx0 + hc) == (qy + ky - 1, qx)
    assert (covered == 1).all()
    for slot in range(6):
        walks = rdb_ops.fwd_tf32_walk(b, h, w, slot)
        items = [it for walk in walks for it in walk]
        nch = rdb_ops._FWD_TF32_SLOT_CHUNKS[slot]
        assert 32 * nch == rdb_ops.CIN[min(slot, 4)]
        assert sorted(items) == [(t, c) for t in range(len(runs))
                                 for c in range(nch)]
        assert all(walk[0][1] == 0 for walk in walks if walk)
        assert len(walks) <= rdb_ops._FWD_CTAS // (1 if slot < 4 else 2)


@pytest.mark.parametrize("layout", ["f32_views", "f32_contiguous"])
def test_fwd_tf32_weight_packing_round_trips(layout):
    """``fwd_tf32_unpack_weights(fwd_tf32_pack_weights(k)) == k`` bit for
    bit (hi + lo is the weight), from f32 HWIO views of OIHW tensors
    (the trainer's parameters) and contiguous kernels; hi is a TF32 value
    (its low 13 bits zero), and the planes lie as the prep writes them:
    slot s, chunk c, ky, hi then lo, row kx * 32 + co, 16-byte chunk k4
    at k4 ^ (row % 8)."""
    ks = _hwio(6)
    if layout == "f32_views":
        ks = [k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
              for k in ks]
        assert not ks[0].is_contiguous()
    packed = rdb_ops.fwd_tf32_pack_weights(ks)
    assert packed.dtype == torch.float32
    assert packed.shape == (rdb_ops._FWD_TF32_WPACK,)
    for a, k in zip(rdb_ops.fwd_tf32_unpack_weights(packed), ks):
        assert torch.equal(a, k)
    planes = packed.view(-1, 3, 2, 96, 8, 4)  # chunk, ky, hi/lo, n, k4, e
    assert not (planes[:, :, 0].contiguous().view(torch.int32)
                & 0x1FFF).any()

    def at(chunk, ky, part, n, k):
        return planes[chunk, ky, part, n, (k // 4) ^ (n % 8), k % 4]

    # conv 2 (slot 1) starts after conv 1's two chunks; its chunk 2 holds
    # input channels 64-95
    k2 = ks[1]
    w = at(2 + 2, 1, 0, 32 * 2 + 5, 7) + at(2 + 2, 1, 1, 32 * 2 + 5, 7)
    assert w == k2[1, 2, 64 + 7, 5]
    # conv 5's second half (slot 5, the last six chunks): output
    # channels 32-63
    w = at(-1, 0, 0, 32 + 3, 30) + at(-1, 0, 1, 32 + 3, 30)
    assert w == ks[4][0, 1, 160 + 30, 32 + 3]


@pytest.mark.parametrize("entry", ["rdb_fwd_cuda", "rdb_fwd_ext_cuda"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_counts_its_launches_by_dtype(monkeypatch, entry, dtype):
    """A forward call adds its five conv launches to its own dtype's
    counter (f32: the 3xTF32 kernels' ``RDB_FWD*_F32_LAUNCHES``) and to no
    other.  The launch itself is stubbed: the CPU has no kernel."""
    monkeypatch.setattr(rdb_ops, "_cuda_operands", lambda *a: None)
    monkeypatch.setattr(rdb_ops, "_fwd_launch", lambda *a: None)
    for name in rdb_ops.LAUNCH_COUNTERS:
        monkeypatch.setattr(rdb_ops, name, 0)
    dt = getattr(torch, dtype)
    bs = [torch.zeros(co) for co in rdb_ops.COUT]
    x = torch.zeros((1, 2, 16, 64), dtype=dt)
    getattr(rdb_ops, entry)(x, _hwio(3, dt), bs)
    ext = "_EXT" if entry == "rdb_fwd_ext_cuda" else ""
    want = f"RDB_FWD{ext}_F32_LAUNCHES" if dt == torch.float32 else \
        f"RDB_FWD{ext}_LAUNCHES"
    assert {n: getattr(rdb_ops, n) for n in rdb_ops.LAUNCH_COUNTERS} == {
        n: 5 if n == want else 0 for n in rdb_ops.LAUNCH_COUNTERS}

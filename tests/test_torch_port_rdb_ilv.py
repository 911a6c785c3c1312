"""The interleaved RDB forward's bf16 data flow (B6 on Hopper) on the CPU.

``csrc/rdb_ilv.cu`` runs only on the card.  Here its schedule and stores
are checked through their Python mirrors (``ilv_schedule``,
``ilv_walk``, ``ilv_runs``, ``ilv_stores``), its data flow through the
plain ``rdb_ilv_runs_reference`` (runs of 128 pixels with a one-pixel
halo, three stores, the zeroed rows) against ``rdb_ilv_reference`` and
the JAX package's ``_rdb_fwd_kernel_ilv`` in interpret mode, and its
prep's packed weights (``ilv_pack_weights``) against the JAX package's
``_repack_ilv(pack_kernel)``.  Inputs come from numpy with a seed.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torchsr_tpu.models.esrgan import ResidualDenseBlock as JaxRDB
from torchsr_tpu.ops.pallas import rdb as jax_rdb
from torchsr_tpu_torch.ops import rdb as rdb_ops

# f32 on both sides, summed in other orders: the JAX ilv test's own
# tolerance (tests/test_pallas_rdb.py), rtol and atol 1e-5.
TOL = 1e-5
# The run-based data flow against the pixel-wise plain version, both f32
# and the same products: at most a few ulp of the sums apart (the limit
# tests/test_pallas_rdb.py holds the ilv kernel to against the slot one).
ATOL_ILV_SLOT = 5e-7
# bf16: each stored value rounded once on both sides; a sum at a
# rounding tie may round one bf16 step (2^-8 of the value) the other way.
BF16_RTOL, BF16_ATOL = 2**-7, 1e-3
ILV_SHAPE = (3, 5, 9, 64)  # odd width, several images


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    params = JaxRDB().init(jax.random.PRNGKey(seed), jnp.asarray(x))
    ks = [np.array(params["params"][f"conv{i}"]["conv"]["kernel"])
          for i in range(1, 6)]
    # nonzero biases, so that a zero or a copy that lands in the wrong
    # row shows
    bs = [rng.normal(0, 0.1, (k.shape[-1],)).astype(np.float32)
          for k in ks]
    return x, ks, bs


@contextlib.contextmanager
def ilv_knob():
    saved = jax_rdb.ILV_KERNEL
    try:
        jax_rdb.ILV_KERNEL = True
        jax.clear_caches()
        yield
    finally:
        jax_rdb.ILV_KERNEL = saved
        jax.clear_caches()


def _image_rows(b, h, w):
    y = torch.arange(b * h * w) // w % h
    return y == 0, y == h - 1


@settings(max_examples=40, deadline=None, database=None)
@given(b=st.integers(1, 4), h=st.integers(1, 9),
       w=st.sampled_from([1, 2, 5, 9, 45, 64, 127, 128, 129, 140, 300]))
def test_ilv_schedule_covers_every_pixel_and_slot_once(b, h, w):
    """Every output pixel is in one run and each CTA's walk takes each
    (run, K stage) once per slot, conv 5's halves the same in each
    cluster; every up, mid and dn row of a grown chunk
    has exactly one writer, holding the pixel above or below (the pixel
    itself for mid), and zeros exactly on an image's first (up) or last
    (dn) row."""
    m = b * h * w
    runs = rdb_ops.ilv_runs(b, h, w)
    assert all(0 < n <= rdb_ops._ILV_OUTS for _, n in runs)
    assert [p for m0, n in runs for p in range(m0, m0 + n)] == list(range(m))
    sched = rdb_ops.ilv_schedule(b, h, w)
    assert sched["runs"] == len(runs)
    for slot, nk in enumerate(rdb_ops._ILV_SLOT_KST):
        walk = rdb_ops.ilv_walk(b, h, w, slot)
        items = sorted(i for cta in walk for i in cta)
        assert items == [(t, k) for t in range(len(runs)) for k in range(nk)]
        # conv 5's halves: the two CTAs of a cluster take the same items
        if slot == 5:
            assert walk == rdb_ops.ilv_walk(b, h, w, 4)
        assert 2 <= sched["ring"][slot] <= rdb_ops._ILV_MAX_STAGES
        assert sched["smem"][slot] <= rdb_ops._ILV_SMEM_DYN
    first, last = _image_rows(b, h, w)
    pix = torch.arange(m)
    for name, (dest, src) in rdb_ops.ilv_stores(b, h, w).items():
        assert torch.equal(torch.sort(dest).values, pix), name
        order = torch.argsort(dest)
        src = src[order]
        zero = {"mid": torch.zeros(m, dtype=torch.bool), "up": first,
                "dn": last}[name]
        assert torch.equal(src < 0, zero), name
        shift = {"mid": 0, "up": -w, "dn": w}[name]
        assert torch.equal(src[~zero], pix[~zero] + shift), name


@pytest.mark.parametrize("shape", [ILV_SHAPE, (4, 1, 9, 64),
                                   (2, 6, 140, 64), (1, 2, 130, 64)],
                         ids=str)
def test_runs_reference_is_the_plain_version(shape):
    """The run-based data flow fills every element of the buffer (no NaN
    left) and equals ``rdb_ilv_reference``: f32 within ATOL_ILV_SLOT,
    bf16 within a rounding step."""
    x, ks, bs = _weights(shape, 3)
    xt, kt, bt = (torch.from_numpy(x), [torch.from_numpy(k) for k in ks],
                  [torch.from_numpy(b) for b in bs])
    out, buf = rdb_ops.rdb_ilv_runs_reference(xt, kt, bt)
    want, want_buf = rdb_ops.rdb_ilv_reference(xt, kt, bt)
    assert not torch.isnan(buf).any()
    torch.testing.assert_close(out, want, rtol=0, atol=ATOL_ILV_SLOT)
    torch.testing.assert_close(buf, want_buf, rtol=0, atol=ATOL_ILV_SLOT)
    xb, kb = xt.bfloat16(), [k.bfloat16() for k in kt]
    out, buf = rdb_ops.rdb_ilv_runs_reference(xb, kb, bt)
    want, want_buf = rdb_ops.rdb_ilv_reference(xb, kb, bt)
    assert not torch.isnan(buf.float()).any()
    torch.testing.assert_close(out.float(), want.float(), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    torch.testing.assert_close(buf.float(), want_buf.float(),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_runs_reference_matches_jax_ilv_kernel():
    """The run-based data flow against the JAX package's
    ``_rdb_fwd_kernel_ilv`` (Pallas, interpret mode) at (3, 5, 9, 64)."""
    x, ks, bs = _weights(ILV_SHAPE, 11)
    with ilv_knob():
        want = np.asarray(jax_rdb.fused_rdb(jnp.asarray(x), ks, bs,
                                            interpret=True))
    out, buf = rdb_ops.rdb_ilv_runs_reference(
        torch.from_numpy(x), [torch.from_numpy(k) for k in ks],
        [torch.from_numpy(b) for b in bs])
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    # x's first chunk: mid is x, up and dn the rows above and below
    up, mid, dn = (buf[..., rdb_ops.ilv_columns(0, p)] for p in range(3))
    xs = torch.from_numpy(x)[..., :32]
    assert torch.equal(mid, xs)
    assert torch.equal(up[:, 1:], xs[:, :-1]) and not up[:, 0].any()
    assert torch.equal(dn[:, :-1], xs[:, 1:]) and not dn[:, -1].any()


@pytest.mark.parametrize("layout", ["f32_views", "strided_bf16"])
def test_packed_weights_equal_jax_repack(layout):
    """The prep's packed weights, unpacked, equal the JAX package's
    ``_repack_ilv(pack_kernel(k))`` of the bf16 kernels element for
    element, from f32 views of OIHW tensors (the trainer's) and from
    strided bf16 views; and element (slot, K stage kk, column n, row k)
    sits at n * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8 of its stage (the
    128-byte swizzle), or at n * 32 + ((k // 8) ^ (n // 2 % 4)) * 8 + k % 8
    in a 32-row last stage (the 64-byte one)."""
    rng = np.random.default_rng(5)
    ks = [rng.normal(0, 0.05, (3, 3, ci, co)).astype(np.float32)
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    if layout == "f32_views":
        kt = [torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
              .permute(2, 3, 1, 0) for k in ks]
    else:  # every other element of a wider bf16 tensor
        kt = [torch.from_numpy(np.repeat(k, 2, axis=-1)).bfloat16()[..., ::2]
              for k in ks]
        assert not kt[0].is_contiguous()
    packed = rdb_ops.ilv_pack_weights(kt)
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == rdb_ops._ILV_WPACK
    unpacked = rdb_ops.ilv_unpack_weights(packed)
    for i, (k, ci) in enumerate(zip(ks, rdb_ops.CIN)):
        kb = jnp.asarray(k).astype(jnp.bfloat16)
        want = np.asarray(jax_rdb._repack_ilv(jax_rdb.pack_kernel(kb), ci)
                          .astype(jnp.float32))
        np.testing.assert_array_equal(unpacked[i].float().numpy(), want)
    offset = 0
    for slot, nk in enumerate(rdb_ops._ILV_SLOT_KST):
        conv, ci, co0 = rdb_ops._fwd_slot(slot)
        kb = jnp.asarray(ks[conv]).astype(jnp.bfloat16)
        rows = np.asarray(jax_rdb._repack_ilv(jax_rdb.pack_kernel(kb), ci)
                          .astype(jnp.float32))
        cols = [dx * rdb_ops.COUT[conv] + co0 + c for dx in range(3)
                for c in range(32)]
        for kk, n, k in ((0, 0, 0), (nk - 1, 95, 7), (nk - 1, 6, 29),
                         (1, 13, 42)):
            half = 3 * ci - 64 * kk == 32  # rows of 32, 64-byte swizzle
            if half:
                at = n * 32 + ((k // 8) ^ (n // 2 % 4)) * 8 + k % 8
            else:
                at = n * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8
            got = packed[offset + kk * 96 * 64 + at]
            assert float(got) == rows[64 * kk + k, cols[n]], (slot, kk, n, k)
        offset += 96 * 3 * ci
    assert offset == packed.numel()

"""The interleaved RDB forward's f32 kernels (B6 as 3xTF32 on Hopper) on
the CPU.

``csrc/rdb_ilv_tf32_sm90.cuh`` runs only on the card.  Here its
arithmetic is checked through ``rdb_ilv_3xtf32_reference`` (the buffer's
prefix and the weights split into TF32 parts, one chain a 32-channel
chunk, the chains summed in f32) against the JAX package's
``_rdb_fwd_kernel_ilv`` in f32 (Pallas, interpret mode) and against
``rdb_ilv_reference``; its schedule through ``ilv_tf32_schedule`` and
``ilv_tf32_walk``; its prep's planes through ``ilv_tf32_pack_weights``
against the JAX package's ``_repack_ilv(pack_kernel)``; its launch
counter by dtype; and ``eval`` with the ILV knob set, whose report must
be the one without it.  Inputs come from numpy with a seed.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from torchsr_tpu.models.esrgan import ResidualDenseBlock as JaxRDB
from torchsr_tpu.ops.pallas import rdb as jax_rdb
from torchsr_tpu_torch.ops import rdb as rdb_ops

# f32 on both sides, the JAX kernel's products exact in f32 and the
# 3xTF32 ones ~2^-21 of each short, summed in other orders: the JAX ilv
# test's own tolerance (tests/test_pallas_rdb.py), rtol and atol 1e-5.
TOL = 1e-5
ILV_SHAPE = (3, 5, 9, 64)  # odd width, several images
ODD_SHAPE = (2, 7, 13, 64)  # odd height and width, runs across images
# eval's whole images (LR of the smoke's 176 x 176, 150 x 203 and 96 x
# 132 HR) and its tile batch
EVAL_SHAPES = [(1, 44, 44), (1, 37, 50), (1, 24, 33), (4, 32, 32)]


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _torch(x, ks, bs):
    return (torch.from_numpy(x), [torch.from_numpy(k) for k in ks],
            [torch.from_numpy(b) for b in bs])


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


@pytest.mark.parametrize("shape", [ILV_SHAPE, ODD_SHAPE], ids=str)
def test_3xtf32_reference_matches_jax_ilv_kernel(shape):
    """The f32 kernels' arithmetic against the JAX package's
    ``_rdb_fwd_kernel_ilv`` in f32 (Pallas, interpret mode, under the
    ILV knob), at rtol and atol 1e-5."""
    x, ks, bs = _weights(shape, 11)
    with ilv_knob():
        want = np.asarray(jax_rdb.fused_rdb(jnp.asarray(x), ks, bs,
                                            interpret=True))
    out, _ = rdb_ops.rdb_ilv_3xtf32_reference(*_torch(x, ks, bs))
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)


def _copies_exact(buf):
    """Each chunk's up copy is the row above's mid (zero on an image's
    first row), its dn copy the row below's (zero on its last)."""
    for j in range(rdb_ops.FEAT // rdb_ops.GROWTH):
        up, mid, dn = (buf[..., rdb_ops.ilv_columns(j, p)] for p in range(3))
        if not (torch.equal(up[:, 1:], mid[:, :-1])
                and torch.equal(dn[:, :-1], mid[:, 1:])
                and not up[:, 0].any() and not dn[:, -1].any()):
            return False
    return True


@pytest.mark.parametrize("shape", [ILV_SHAPE, ODD_SHAPE], ids=str)
def test_3xtf32_reference_is_the_plain_version(shape):
    """The f32 kernels' arithmetic against ``rdb_ilv_reference`` (f32
    operands): output and buffer within 1e-5; x's chunks as they are, and
    every chunk's up and dn copies exactly the rows above and below."""
    xt, kt, bt = _torch(*_weights(shape, 3))
    out, buf = rdb_ops.rdb_ilv_3xtf32_reference(xt, kt, bt)
    want, want_buf = rdb_ops.rdb_ilv_reference(xt, kt, bt)
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(buf, want_buf, rtol=TOL, atol=TOL)
    assert torch.equal(buf[..., rdb_ops.ilv_columns(0, 1)], xt[..., :32])
    assert torch.equal(buf[..., rdb_ops.ilv_columns(1, 1)], xt[..., 32:])
    assert _copies_exact(buf)


def test_3xtf32_reference_sums_each_chunks_chain():
    """The reference takes the kernel's products (``terms``) and nothing
    else: with hi.hi only, conv 1's chunk (its 96 prefix columns) is the
    product of the TF32-rounded operands, the same in every chunk's
    chain."""
    from torchsr_tpu_torch.ops.tf32 import tf32_split

    xt, kt, bt = _torch(*_weights(ILV_SHAPE, 5))
    hh = (("hi", "hi"),)
    _, buf = rdb_ops.rdb_ilv_3xtf32_reference(xt, kt, bt, terms=hh)
    wi = rdb_ops.repack_ilv(rdb_ops.pack_kernel(kt[0]), 64)
    a = tf32_split(buf[..., :192])[0]
    y = (a[..., :96] @ tf32_split(wi)[0][:96]
         + a[..., 96:] @ tf32_split(wi)[0][96:])
    grown = torch.nn.functional.leaky_relu(
        rdb_ops._reduce_taps(y, 32) + bt[0], 0.2)
    torch.testing.assert_close(buf[..., rdb_ops.ilv_columns(2, 1)], grown,
                               rtol=0, atol=0)


@settings(max_examples=40, deadline=None, database=None)
@given(b=st.integers(1, 4), h=st.integers(1, 9),
       w=st.sampled_from([1, 2, 5, 9, 33, 44, 45, 64, 127, 128, 129, 300]))
def test_ilv_tf32_schedule_covers_every_pixel_and_slot_once(b, h, w):
    """Every output pixel is in one run (``ilv_runs``, the bf16 kernels'
    runs); each CTA's walk takes each (run, K stage of 32 columns) once
    per slot, conv 5's halves the same items; the ring's items fit the
    card's shared memory twice at least."""
    _holds_schedule(b, h, w)


@pytest.mark.parametrize("bhw", EVAL_SHAPES, ids=str)
def test_ilv_tf32_schedule_at_the_eval_shapes(bhw):
    """The same at ``eval``'s whole images and tile batch: fewer runs
    than SMs, every CTA given one."""
    sched = _holds_schedule(*bhw)
    assert sched["conv_ctas"] == sched["runs"] <= rdb_ops._ILV_CTAS


def _holds_schedule(b, h, w):
    m = b * h * w
    runs = rdb_ops.ilv_runs(b, h, w)
    assert [p for m0, n in runs for p in range(m0, m0 + n)] == list(range(m))
    sched = rdb_ops.ilv_tf32_schedule(b, h, w)
    assert sched["runs"] == len(runs)
    assert sched["kstages"] == tuple(3 * ci // 32 for ci in
                                     (*rdb_ops.CIN, rdb_ops.CIN[4]))
    for slot, nk in enumerate(sched["kstages"]):
        walk = rdb_ops.ilv_tf32_walk(b, h, w, slot)
        assert all(walk), "an idle CTA"
        items = sorted(i for cta in walk for i in cta)
        assert items == [(t, k) for t in range(len(runs)) for k in range(nk)]
        assert nk % 3 == 0  # whole chunks: a chain ends in the run
        if slot == 5:
            assert walk == rdb_ops.ilv_tf32_walk(b, h, w, 4)
    assert 2 <= sched["stages"] <= rdb_ops._ILV_MAX_STAGES
    assert sched["smem"] == 1024 + sched["stages"] * sched["stage_bytes"]
    assert sched["smem"] <= rdb_ops._FWD_SMEM_DYN
    return sched


@pytest.mark.parametrize("layout", ["f32_views", "f32_contiguous"])
def test_ilv_tf32_weight_packing_equals_jax_repack(layout):
    """The prep's planes unpack to the JAX package's
    ``_repack_ilv(pack_kernel(k))`` exactly, from contiguous HWIO kernels
    or the HWIO views of OIHW parameters the trainer hands over; every hi
    holds only TF32 bits; K stage kk of a slot is its 32 ``repack_ilv``
    rows 32 kk .., element (kk, column n, row k) of the hi plane at n * 32
    + ((k // 4) ^ (n % 8)) * 4 + k % 4 (the 128-byte swizzle)."""
    rng = np.random.default_rng(7)
    ks = [rng.normal(0, 0.05, (3, 3, ci, co)).astype(np.float32)
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    kt = [torch.from_numpy(k) for k in ks]
    if layout == "f32_views":
        kt = [k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
              for k in kt]
    packed = rdb_ops.ilv_tf32_pack_weights(kt)
    assert packed.numel() == rdb_ops._FWD_TF32_WPACK
    planes = packed.view(-1, 2, 96 * 32)
    assert not (planes[:, 0].view(torch.int32) & 0x1FFF).any()
    unpacked = rdb_ops.ilv_tf32_unpack_weights(packed)
    for i, (k, ci) in enumerate(zip(ks, rdb_ops.CIN)):
        want = np.asarray(jax_rdb._repack_ilv(
            jax_rdb.pack_kernel(jnp.asarray(k)), ci))
        np.testing.assert_array_equal(unpacked[i].numpy(), want)
    from torchsr_tpu_torch.ops.tf32 import tf32_split

    offset = 0
    for slot, nk in enumerate(rdb_ops._ILV_TF32_SLOT_KST):
        conv, ci, co0 = rdb_ops._fwd_slot(slot)
        rows = tf32_split(torch.from_numpy(np.array(jax_rdb._repack_ilv(
            jax_rdb.pack_kernel(jnp.asarray(ks[conv])), ci))))[0]
        cols = [dx * rdb_ops.COUT[conv] + co0 + c for dx in range(3)
                for c in range(32)]
        for kk, n, k in ((0, 0, 0), (nk - 1, 95, 31), (nk - 1, 6, 29),
                         (1, 13, 10)):
            at = n * 32 + ((k // 4) ^ (n % 8)) * 4 + k % 4
            got = packed[offset + kk * 2 * 96 * 32 + at]
            assert float(got) == float(rows[32 * kk + k, cols[n]]), (
                slot, kk, n, k)
        offset += nk * 2 * 96 * 32
    assert offset == packed.numel()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ilv_forward_counts_its_launches_by_dtype(monkeypatch, dtype):
    """An interleaved forward adds its five conv launches to its own
    dtype's counter (f32: the 3xTF32 kernels' ``RDB_FWD_ILV_F32_LAUNCHES``)
    and to no other; both go through the one prep-and-five-convs entry.
    The launch itself is stubbed: the CPU has no kernel."""
    seen = []
    monkeypatch.setattr(rdb_ops, "_cuda_operands", lambda *a: None)
    monkeypatch.setattr(rdb_ops, "_fwd_launch",
                        lambda lib, x, *a: seen.append((lib, x.dtype)))
    for name in rdb_ops.LAUNCH_COUNTERS:
        monkeypatch.setattr(rdb_ops, name, 0)
    dt = getattr(torch, dtype)
    ks = [torch.zeros((3, 3, ci, co), dtype=dt)
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    bs = [torch.zeros(co) for co in rdb_ops.COUT]
    out, buf = rdb_ops.rdb_fwd_ilv_cuda(torch.zeros((1, 2, 9, 64), dtype=dt),
                                        ks, bs)
    assert seen == [("rdb_ilv", dt)]
    assert buf.shape == (1, 2, 9, 576) and buf.dtype == dt
    want = ("RDB_FWD_ILV_F32_LAUNCHES" if dt == torch.float32
            else "RDB_FWD_ILV_LAUNCHES")
    assert {n: getattr(rdb_ops, n) for n in rdb_ops.LAUNCH_COUNTERS} == {
        n: 5 if n == want else 0 for n in rdb_ops.LAUNCH_COUNTERS}


def test_ilv_f32_entry_is_the_3xtf32_launch():
    """The f32 forward's one entry in the interleaved library is the
    3xTF32 one (prep and five convs, the slot forwards' signature), and
    the FFMA entries are gone."""
    from torchsr_tpu_torch.ops import _build

    entries = _build.SIGNATURES["rdb_ilv"]
    assert rdb_ops._FWD_TF32_ENTRY["rdb_ilv"] == "rdb_ilv_tf32_launch"
    assert entries["rdb_ilv_tf32_launch"] == \
        _build.SIGNATURES["rdb_fwd"]["rdb_fwd_tf32_launch"]
    assert "rdb_ilv_tf32_schedule" in entries
    assert not [e for e in entries if e.startswith("rdb_ilv_f32_")]


@pytest.mark.parametrize("extra", [{}, {"tile": 16, "tile_overlap": 4,
                                        "tile_batch": 2}],
                         ids=["whole", "tiled"])
def test_eval_with_the_ilv_knob_gives_the_same_report(tmp_path, monkeypatch,
                                                      extra):
    """``eval`` (f32, a 1-RRDB ESRGAN) with ``ILV_KERNEL`` set takes the
    interleaved variant in every block (on the CPU its plain version) and
    scores each image as without it, to the report's last digit; the SR
    images agree to 1e-5."""
    from argparse import Namespace

    from torchsr_tpu_torch.infer.evaluate import run_eval
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
    from torchsr_tpu_torch.utils import image_io
    from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(4)
    (tmp_path / "val").mkdir()
    for name, hw in {"a.png": (72, 80), "b.png": (68, 90)}.items():
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(
            tmp_path / "val" / name)
    gen = ESRGANGenerator(num_rrdb_blocks=1,
                          generator=torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "g.pth")
    save_checkpoint(ckpt, 1, "gan", gen.state_dict())
    calls = []
    plain = rdb_ops.rdb_ilv_reference

    def spy(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(rdb_ops, "rdb_ilv_reference", spy)
    monkeypatch.chdir(tmp_path)
    srs, reports = {}, {}
    save = image_io.save_image
    for knob in (False, True):
        monkeypatch.setattr(rdb_ops, "ILV_KERNEL", knob)
        got = srs[knob] = {}
        monkeypatch.setattr(image_io, "save_image", lambda im, p: (
            got.__setitem__(os.path.basename(p), np.array(im)), save(im, p)))
        args = Namespace(image_dir="val", model="esrgan", checkpoint=ckpt,
                         crop=None, tile=0, tile_overlap=16, tile_batch=8,
                         bf16=False, save_sr=True, report=None, device="cpu")
        for k, v in extra.items():
            setattr(args, k, v)
        before = len(calls)
        reports[knob] = run_eval(args, ESRGANGenerator)
        assert (len(calls) > before) == knob
    for a, b in zip(reports[False]["per_image"], reports[True]["per_image"]):
        assert a["image"] == b["image"]
        assert abs(a["psnr"] - b["psnr"]) <= 1e-4, (a, b)
        assert abs(a["ssim"] - b["ssim"]) <= 1e-5, (a, b)
        key = f"upres-{a['image']}"
        np.testing.assert_allclose(srs[True][key], srs[False][key], rtol=0,
                                   atol=1e-5)

"""The limits chip_smoke.py holds the RDB kernels to, checked on the CPU.

The CUDA kernels run only on the card.  Here their arithmetic is
emulated in plain PyTorch (the forward: each launch's f32 sum rounded
once to the storage dtype, as the kernel stores it; the backward:
chip_smoke.py's own ``emulated_bwd``), and chip_smoke.py's scoring must
pass that emulation and fail the same emulation with a fault put in:
a forward launch left at zero or with its taps mirrored; a backward
with one conv's dW left at zero, LeakyReLU' taken as 1, the dgrad taps
not flipped, conv5's cotangent left out of every dense gradient, or the
slot convs stopping short of it.  The
same for the pair synthesis (B3: H pass first, no quantization between
the passes, flip columns swapped, a true division by 255) and the 3x3
64 -> 64 conv (B4, B5: K transposed, no column mask, bias dropped, dx
with the unflipped kernel, one CTA's dW partial dropped; in f32 the
3xTF32 arithmetic passes and plain TF32, or 3xTF32 short of lo.hi,
fails; the same for the f32 RDB forward, launch by launch and for the
block, flat and row-extended, and its profile held to six kernels a
call, a window short of whole calls run again).  The eval
phase's checks run on the port's CPU ``eval``: the float64 recompute of
a report (an SR one level off on a patch, a box window in the SSIM),
the skip rule, and the forward count B1's launches are held to.  The
multistep phase's noise floor and limit run on a CPU trainer: equal
steps pass, a stale batch and another learning rate fail.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchsr_tpu_torch.ops import pair_conv as pc_ops
from torchsr_tpu_torch.ops import preprocess as ps_ops
from torchsr_tpu_torch.ops import rdb as rdb_ops

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SHAPE = (2, 8, 12, 64)
DTYPES = [torch.float32, torch.bfloat16]


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(dtype):
    x = np.random.default_rng(7).normal(0, 0.5, SHAPE).astype(np.float32)
    ks, bs = smoke._rdb_weights(torch.Generator().manual_seed(7), "cpu")
    return (torch.from_numpy(x).to(dtype), [k.to(dtype) for k in ks], bs)


def _emulated_kernel(x, ks, bs, wrong_stage=None, fault=None):
    """The five launches of ``rdb_fwd.cu`` in plain PyTorch; launch
    ``wrong_stage`` optionally carries ``fault``."""
    dt = x.dtype
    feat = torch.zeros((*x.shape[:3], rdb_ops.FEAT), dtype=dt)
    feat[..., :rdb_ops.CHANNELS] = x
    for i, (cin, cout) in enumerate(zip(rdb_ops.CIN, rdb_ops.COUT)):
        k = ks[i].float()
        if i == wrong_stage and fault == "mirrored_taps":
            k = k.flip(0, 1)
        acc = smoke.conv3x3(feat[..., :cin].float(), k, bs[i])
        if i == wrong_stage and fault == "zeros":
            acc = 0 * acc if i < 4 else None
        if i < 4:
            feat[..., cin:cin + cout] = F.leaky_relu(acc, 0.2).to(dt)
        elif acc is None:  # conv5 skipped: the block returns x
            out = x.clone()
        else:
            out = (x.float() + smoke.SCALE * acc).to(dt)
    return out, feat


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_limits_pass_the_kernels_rounding(dtype):
    x, ks, bs = _inputs(dtype)
    row = smoke.rdb_scores(x, ks, bs, *_emulated_kernel(x, ks, bs))
    assert max(row["stage_excess"]) <= 1, row
    assert row["block_excess"] <= 1, row
    assert min(row["stage_wrong_excess"]) > 1, row
    assert min(row["block_wrong_excess"].values()) > 1, row


@pytest.mark.parametrize("fault", ["zeros", "mirrored_taps"])
@pytest.mark.parametrize("stage", range(5))
def test_limits_catch_one_wrong_launch(stage, fault):
    x, ks, bs = _inputs(torch.bfloat16)
    out, feat = _emulated_kernel(x, ks, bs, stage, fault)
    row = smoke.rdb_scores(x, ks, bs, out, feat)
    assert row["stage_excess"][stage] > 1, row
    assert row["block_excess"] > 1, row


# Whole-row runs (W <= 64), and runs inside a row with extension pixels
# mid-row (W = 140: two runs a row)
KXPACK_SHAPES = [(2, 12, 24, 64), (1, 4, 140, 64)]


@pytest.mark.parametrize("shape", KXPACK_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kxpack_emulation_passes_and_its_faults_show(dtype, shape):
    """chip_smoke's emulation of the bf16 kernels' kx-packed data flow is
    ``rdb_fwd_kxpack_reference`` and passes the launch and block limits;
    each ``WRONG_KXPACK`` fault (row-end masks dropped, a run's
    extension pixels at zero, y0 and y2 exchanged) fails them where it
    can show: a run's extension pixels lie mid-row only where W > 64."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32))
    x = x.to(dtype)
    _, ks, bs = _inputs(dtype)
    out, feat = smoke.kxpack_emulated_fwd(x, ks, bs)
    want = rdb_ops.rdb_fwd_kxpack_reference(x, ks, bs,
                                            scale_ratio=smoke.SCALE)
    assert torch.equal(out, want[0]) and torch.equal(feat, want[1])
    row = smoke.rdb_scores(x, ks, bs, out, feat)
    assert max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1, row
    wrong = smoke.kxpack_wrong_excess(x, ks, bs)
    wide = shape[2] > rdb_ops._FWD_NARROW_W
    assert smoke.edge_runs(shape) == wide
    assert set(wrong) == set(smoke.WRONG_KXPACK) - (
        set() if wide else {"run_edge_lost"})
    assert min(wrong.values()) > 1, wrong


def test_fwd_profile_check_takes_only_own_kernels():
    """A bf16 forward call's profile passes with its prep and five convs
    and fails with a cast beside them or a seventh kernel."""
    own = [["rdb_fwd_sm90::rdb_fwd_prep<float>", 0.01]] + [
        ["rdb_fwd_sm90::rdb_fwd_conv", 0.02]] * 5
    smoke.check_fwd_profile({"kernels_per_call": 6, "by_launch": own}, "ok")
    cast = own[:5] + [["at::native::vectorized_elementwise_kernel", 0.01]]
    for bad in ({"kernels_per_call": 6, "by_launch": cast},
                {"kernels_per_call": 7, "by_launch": own + own[:1]}):
        with pytest.raises(RuntimeError, match="own kernels"):
            smoke.check_fwd_profile(bad, "bad")


def test_fwd_profile_check_holds_f32_to_its_six_kernels():
    """An f32 forward call's profile passes with the 3xTF32 prep and five
    convs, and fails one kernel short, with a bf16 kernel in it, or with
    a cast beside them."""
    own = [["rdb_fwd_tf32::rdb_fwd_tf32_prep", 0.003]] + [
        ["rdb_fwd_tf32::rdb_fwd_tf32_conv", 0.05]] * 5
    smoke.check_fwd_profile({"kernels_per_call": 6, "by_launch": own},
                            "ok", torch.float32)
    bf16 = own[:5] + [["rdb_fwd_sm90::rdb_fwd_conv", 0.01]]
    cast = own[:5] + [["at::native::vectorized_elementwise_kernel", 0.01]]
    for bad in ({"kernels_per_call": 5, "by_launch": own[:5]},
                {"kernels_per_call": 6, "by_launch": bf16},
                {"kernels_per_call": 6, "by_launch": cast}):
        with pytest.raises(RuntimeError, match="own kernels"):
            smoke.check_fwd_profile(bad, "bad", torch.float32)


def test_profile_runs_a_window_short_of_whole_calls_again(monkeypatch):
    """Where a call's kernels are known, a window that lost a multiple of
    ``calls`` events (50 of 60: whole calls by count) is run again, and
    the next whole one is read; one that never comes fails."""
    windows = []

    def spans(fn, calls):
        n = 50 if not windows else 60
        windows.append(n)
        return [(i, i + 1, f"k{i % 6}") for i in range(n)]

    monkeypatch.setattr(smoke, "device_spans", spans)
    prof = smoke.bwd_profile(lambda: None, calls=10, kernels=6)
    assert windows == [50, 60] and prof["kernels_per_call"] == 6
    windows.clear()
    assert smoke.bwd_profile(lambda: None, calls=10)["kernels_per_call"] == 5
    monkeypatch.setattr(smoke, "device_spans",
                        lambda fn, calls: [(0, 1, "k")] * 50)
    with pytest.raises(RuntimeError, match="whole calls"):
        smoke.bwd_profile(lambda: None, calls=10, kernels=6)


@pytest.mark.parametrize("padded", [False, True], ids=["b1", "b7"])
@pytest.mark.parametrize("shape", [SHAPE, (1, 4, 140, 64)], ids=str)
def test_rdb_limits_pass_3xtf32_and_fail_plain_tf32(shape, padded):
    """The f32 RDB forward's 3xTF32 arithmetic (emulated) passes the f32
    limits launch by launch and for the block, flat (B1) and on the
    padded buffer's data rows (B7); plain TF32 (hi.hi only) and 3xTF32
    with lo.hi dropped read over both."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32))
    _, ks, bs = _inputs(torch.float32)
    out, feat = rdb_ops.rdb_fwd_3xtf32_reference(x, ks, bs, smoke.SCALE,
                                                 padded=padded)
    row = smoke.rdb_scores(x, ks, bs, out, feat[:, 1:-1] if padded else feat)
    assert max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1, row
    wrong = smoke.tf32_wrong_excess(x, ks, bs, padded=padded)
    assert set(wrong) == set(smoke.WRONG_PAIR_TF32)
    assert min(min(r.values()) for r in wrong.values()) > 1, wrong


def test_tf32_block_is_the_plain_tf32_forward():
    """The generator's and eval's wrong block multiplies in plain TF32:
    the hi.hi emulation, over the f32 block limit against the plain
    block."""
    x, ks, bs = _inputs(torch.float32)
    got = smoke.tf32_block(x, ks, bs, scale_ratio=smoke.SCALE)
    want = rdb_ops.rdb_fwd_3xtf32_reference(
        x, ks, bs, smoke.SCALE, terms=(("hi", "hi"),))[0]
    assert torch.equal(got, want)
    ref = rdb_ops.rdb_reference(x, ks, bs, scale_ratio=smoke.SCALE)
    assert smoke.excess(got, ref, smoke.BLOCK_LIMITS[torch.float32], x) > 1


def test_kernel_path_refuses_cpu_tensors():
    """The kernel path takes CUDA tensors only; the CPU goes through
    ``fused_rdb``'s plain version."""
    x, ks, bs = _inputs(torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        rdb_ops.rdb_fwd_cuda(x, ks, bs)


def _bwd_inputs(dtype, shape=SHAPE):
    x, ks, bs = _inputs(dtype)
    x = x[:shape[0], :shape[1], :shape[2]]
    g = torch.from_numpy(np.random.default_rng(8).normal(
        0, 0.1, x.shape).astype(np.float32)).to(dtype)
    _, feat = rdb_ops._rdb_plain(x, ks, bs, smoke.SCALE)
    return g, feat, ks


def _held(got, want, dtype) -> float:
    """The largest excess of a backward (dx, dws, dbs, DY) against
    another on the same inputs, at the whole backward's limits (in bf16 a
    cotangent rounded one step apart feeds the next slot's sum)."""
    lim = smoke.BWD_BLOCK_LIMITS[dtype]
    return max(smoke.excess(a, b, lim) for a, b in zip(
        (got[0], *got[1], *got[2], got[3]),
        (want[0], *want[1], *want[2], want[3])))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_emulation_is_the_plain_backward(dtype):
    """chip_smoke's emulation of the bf16 kernels' data flow (a sum of
    dgrads per slot) against ``rdb_bwd_dy_reference`` (one conv over the
    DY suffix per slot): the same products summed in another order."""
    g, feat, ks = _bwd_inputs(dtype)
    got = smoke.emulated_bwd(g, feat, ks, smoke.SCALE)
    want = rdb_ops.rdb_bwd_dy_reference(g, feat, ks, smoke.SCALE)
    assert [t.shape for t in (got[0], got[3])] == \
        [t.shape for t in (want[0], want[3])]
    assert _held(got, want, dtype) <= 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_limits_pass_the_dy_reference(dtype):
    """``rdb_bwd_dy_reference``, the plain version of the kernels' data
    flow, passes every stage and block limit of chip_smoke's backward
    check."""
    g, feat, ks = _bwd_inputs(dtype)
    row = smoke.bwd_scores(g, feat, ks, rdb_ops.rdb_bwd_dy_reference(
        g, feat, ks, smoke.SCALE))
    assert smoke._worst(row) <= 1, row


@pytest.mark.parametrize("shape", [SHAPE, (1, 5, 7, 64)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_limits_pass_the_kernels_arithmetic(dtype, shape):
    g, feat, ks = _bwd_inputs(dtype, shape)
    row = smoke.bwd_scores(g, feat, ks,
                           smoke.emulated_bwd(g, feat, ks, smoke.SCALE))
    assert smoke._worst(row) <= 1, row


@pytest.mark.parametrize("fault", smoke.WRONG_BWD)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_limits_catch_each_wrong_kernel(dtype, fault):
    g, feat, ks = _bwd_inputs(dtype)
    row = smoke.bwd_scores(g, feat, ks, smoke.emulated_bwd(
        g, feat, ks, smoke.SCALE, fault))
    assert smoke._worst(row) > 1, row


@pytest.mark.parametrize("shape", [SHAPE, (1, 5, 7, 64)], ids=str)
def test_bwd_limits_pass_3xtf32_and_fail_plain_tf32(shape):
    """The f32 backward's arithmetic (``rdb_bwd_3xtf32_reference``: every
    product as three TF32 ones) passes every f32 stage, cotangent and
    block limit of chip_smoke's backward check; plain TF32 and 3xTF32
    without lo.hi (``WRONG_BWD_TF32``) read over them."""
    g, feat, ks = _bwd_inputs(torch.float32, shape)
    row = smoke.bwd_scores(g, feat, ks, rdb_ops.rdb_bwd_3xtf32_reference(
        g, feat, ks, smoke.SCALE))
    assert smoke._worst(row) <= 1, row
    for fault, terms in smoke.WRONG_BWD_TF32.items():
        bad = smoke.bwd_scores(g, feat, ks, rdb_ops.rdb_bwd_3xtf32_reference(
            g, feat, ks, smoke.SCALE, terms=terms))
        assert smoke._worst(bad) > 1, (fault, bad)


def test_bwd_wrong_rows_hold_the_f32_products():
    """chip_smoke's ``bwd_wrong`` in f32: every ``WRONG_BWD`` and
    ``WRONG_BWD_TF32`` kernel reads over the limits, the emulated 3xTF32
    backward within them."""
    g, feat, ks = _bwd_inputs(torch.float32)
    row = smoke.bwd_wrong(g, feat, ks)
    assert set(row["wrong"]) == {*smoke.WRONG_BWD, *smoke.WRONG_BWD_TF32}
    assert min(row["wrong"].values()) > 1 and row["emulated"] <= 1, row


def test_bwd_profile_check_holds_f32_to_its_eight_kernels():
    """An f32 backward call's profile passes with the 3xTF32 prep, five
    slot convs, wgrad and reduce, and fails one kernel short, with a bf16
    kernel in it, or with a copy beside them."""
    own = ([["rdb_bwd_tf32::rdb_bwd_tf32_prep", 0.01]]
           + [["rdb_bwd_tf32::rdb_bwd_tf32_slot_conv", 0.05]] * 5
           + [["rdb_bwd_tf32::rdb_bwd_tf32_wgrad", 0.7],
              ["rdb_bwd_tf32::rdb_bwd_tf32_reduce", 0.01]])
    smoke.check_bwd_profile({"kernels_per_call": 8, "by_launch": own},
                            torch.float32, "ok")
    bf16 = own[:7] + [["rdb_bwd_sm90::rdb_bwd_reduce", 0.01]]
    copy = own[:7] + [["at::native::elementwise_kernel<copy_>", 0.01]]
    for bad in ({"kernels_per_call": 7, "by_launch": own[:7]},
                {"kernels_per_call": 8, "by_launch": bf16},
                {"kernels_per_call": 8, "by_launch": copy}):
        with pytest.raises(RuntimeError, match="own kernels"):
            smoke.check_bwd_profile(bad, torch.float32, "bad")


def test_train_grad_limit_catches_a_wrong_backward():
    """The generator-gradient comparison of chip_smoke.py's train_grad
    phase, on the CPU at 1 RRDB: the plain path through the Function
    (plain backward) is within the f32 limit of autograd through
    ``rdb_reference``; the wrong backward (LeakyReLU' as 1) is not."""
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator

    gen = ESRGANGenerator(num_rrdb_blocks=1,
                          generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    x = torch.rand((2, 8, 8, 3), generator=g)
    hr = torch.rand((2, 32, 32, 3), generator=g)
    params = list(gen.parameters())

    def grads(fn):
        return torch.autograd.grad((fn(x) - hr).abs().mean(), params)

    def wrong(y, kernels, biases, *, scale_ratio):
        return smoke._WrongBwdBlock.apply(y, "lrelu_one", *kernels, *biases)

    ref = grads(lambda t: smoke.plain_generator(gen, t))
    limit = smoke.TOL_GRAD[torch.float32]
    assert max(smoke._rel_grads(grads(gen), ref)) <= limit
    assert max(smoke._rel_grads(
        grads(lambda t: smoke.plain_generator(gen, t, wrong)), ref)) > limit


@pytest.mark.parametrize("name, cls", [
    ("void (anonymous namespace)::tensor_core::conv3x3_bf16<64, 32, false>"
     "(...)", "rdb_fwd"),
    ("void rdb_fwd_sm90::rdb_fwd_conv(__nv_bfloat16*, ...)", "rdb_fwd"),
    ("void rdb_fwd_sm90::rdb_fwd_prep<float>(...)", "rdb_fwd"),
    ("void rdb_bwd_sm90::rdb_bwd_slot_conv(__nv_bfloat16*, ...)", "rdb_bwd"),
    ("void rdb_bwd_sm90::rdb_bwd_wgrad(...)", "rdb_bwd"),
    ("void rdb_bwd_sm90::rdb_bwd_prep<float>(...)", "rdb_bwd"),
    ("void (anonymous namespace)::tensor_core::wgrad_bf16(...)",
     "other_conv"),
    ("void rdb_bwd_tf32::rdb_bwd_tf32_wgrad(float const*, ...)", "rdb_bwd"),
    ("void rdb_bwd_tf32::rdb_bwd_tf32_slot_conv(CUtensorMap_st, ...)",
     "rdb_bwd"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
     "<...>(...)", "optimizer"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "other_conv"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
])
def test_profile_kernel_classes(name, cls):
    assert smoke._kernel_class(name) == cls


EXT_SHAPE = (2, 6, 16, 64)  # eligible for the row-extended kernels


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ext_emulation_is_the_plain_version_and_its_fault_shows(dtype):
    """chip_smoke's emulation of B7 equals ``rdb_ext_reference``; the
    limits pass it, and see a kernel that writes the pad rows."""
    x, ks, bs = _inputs(dtype)
    x = x[:EXT_SHAPE[0], :EXT_SHAPE[1], :EXT_SHAPE[2]]
    out, feat = smoke.ext_emulated_fwd(x, ks, bs)
    want_out, want_feat = rdb_ops.rdb_ext_reference(x, ks, bs,
                                                    scale_ratio=smoke.SCALE)
    # the same products summed in another order (a convolution here, a
    # matmul per row offset there)
    assert smoke.excess(out, want_out, smoke.BLOCK_LIMITS[dtype], x) <= 1
    assert smoke.excess(feat, want_feat, smoke.STAGE_LIMITS[dtype]) <= 1
    assert not feat[:, [0, -1]].any()
    row = smoke.rdb_scores(x, ks, bs, out, feat[:, 1:-1])
    assert max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1, row
    w_out, w_feat = smoke.ext_emulated_fwd(x, ks, bs, "pad_rows_written")
    assert w_feat[:, [0, -1]].abs().max() > 0
    wrong = smoke.rdb_scores(x, ks, bs, w_out, w_feat[:, 1:-1])
    assert max(wrong["stage_excess"]) > 1, wrong


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ilv_emulation_is_the_plain_version_and_its_fault_shows(dtype):
    """chip_smoke's emulation of B6 equals ``rdb_ilv_reference``; its
    mid copies pass the limits and its up/dn copies are exact; a kernel
    that swaps chunk 0's up and dn copies fails both."""
    x, ks, bs = _inputs(dtype)
    out, buf = smoke.ilv_emulated_fwd(x, ks, bs)
    want_out, want_buf = rdb_ops.rdb_ilv_reference(x, ks, bs,
                                                   scale_ratio=smoke.SCALE)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(buf, want_buf, rtol=0, atol=0)
    assert smoke.ilv_copies_exact(buf)
    row = smoke.rdb_scores(x, ks, bs, out, smoke.ilv_mid(buf))
    assert max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1, row
    w_out, w_buf = smoke.ilv_emulated_fwd(x, ks, bs, "up_dn_swapped")
    assert not smoke.ilv_copies_exact(w_buf)
    wrong = smoke.rdb_scores(x, ks, bs, w_out, smoke.ilv_mid(w_buf))
    assert max(wrong["stage_excess"]) > 1, wrong


# chip_smoke's B6 shapes where each wrong kernel can show: several
# images and runs (SHAPE: 192 pixels, a run's end halo inside a row),
# single-row images (only the edge zeroing shows), the wide rows.
ILV_FAULT_SHAPES = [SHAPE, (4, 1, 9, 64), (2, 6, 140, 64)]


@pytest.mark.parametrize("shape", ILV_FAULT_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ilv_limits_catch_each_wrong_kernel(dtype, shape):
    """Each ``WRONG_ILV`` fault (copies swapped, the image-edge zeroing
    skipped, a run's end halo pixel dropped) that can show at the shape
    reads above the launch limits; at (4, 1, 9) only the skipped edge
    zeroing can (every row is an image's first and last)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32))
    x = x.to(dtype)
    _, ks, bs = _inputs(dtype)
    wrong = smoke.ilv_wrong_excess(x, ks, bs)
    edge = shape[1] == 1
    assert set(wrong) == ({"edge_zero_skipped"} if edge
                          else set(smoke.WRONG_ILV)), wrong
    assert min(v["stage"] for v in wrong.values()) > 1, wrong


def _bwd_ext_inputs(dtype):
    x, ks, bs = _inputs(dtype)
    x = x[:EXT_SHAPE[0], :EXT_SHAPE[1], :EXT_SHAPE[2]]
    g = torch.from_numpy(np.random.default_rng(9).normal(
        0, 0.1, x.shape).astype(np.float32)).to(dtype)
    _, featp = rdb_ops.rdb_ext_reference(x, ks, bs, scale_ratio=smoke.SCALE)
    return g, featp, ks


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_ext_emulation_is_the_plain_version(dtype):
    """chip_smoke's emulation of B8 against ``rdb_bwd_dy_reference`` on
    the padded layout (DY's pad rows zero in both), its gradients against
    ``rdb_bwd_ext_reference``, and within chip_smoke's limits."""
    g, featp, ks = _bwd_ext_inputs(dtype)
    got = smoke.emulated_bwd_ext(g, featp, ks, smoke.SCALE)
    want = rdb_ops.rdb_bwd_dy_reference(g, featp, ks, smoke.SCALE,
                                        padded=True)
    assert got[3].shape == want[3].shape == (*featp.shape[:3], rdb_ops.FEAT)
    assert not got[3][:, [0, -1]].any() and not want[3][:, [0, -1]].any()
    assert _held(got, want, dtype) <= 1
    ext = rdb_ops.rdb_bwd_ext_reference(g, featp, ks, smoke.SCALE)
    lim = smoke.BWD_BLOCK_LIMITS[dtype]
    assert max(smoke.excess(a, b, lim) for a, b in zip(
        (got[0], *got[1], *got[2]), (ext[0], *ext[1], *ext[2]))) <= 1
    unpadded = (*got[:3], got[3][:, 1:-1])
    assert smoke._worst(smoke.bwd_scores(g, featp[:, 1:-1], ks,
                                         unpadded)) <= 1


@pytest.mark.parametrize("fault", smoke.WRONG_BWD_EXT)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_ext_limits_catch_each_wrong_kernel(dtype, fault):
    g, featp, ks = _bwd_ext_inputs(dtype)
    *grads, dyp = smoke.emulated_bwd_ext(g, featp, ks, smoke.SCALE, fault)
    row = smoke.bwd_scores(g, featp[:, 1:-1], ks, (*grads, dyp[:, 1:-1]))
    assert smoke._worst(row) > 1, row


SYNTH_SHAPE = (4, 32)  # crops, side: mixed flips


def _synth_inputs():
    rng = np.random.default_rng(11)
    b, s = SYNTH_SHAPE
    crops = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3),
                                          dtype=np.uint8))
    flips = torch.tensor([[1, 0], [0, 1], [1, 1], [0, 0]], dtype=torch.bool)
    return crops, flips


def test_synth_limits_pass_the_plain_arithmetic():
    """The kernel's arithmetic (the plain version, and chip_smoke's own
    emulation of it) passes B3's limits."""
    crops, flips = _synth_inputs()
    ref = smoke.synthesize_pair(crops, flips)
    row = smoke.synth_scores(ps_ops.synthesize_pair_cuda(crops, flips), ref)
    assert smoke.synth_ok(row) and row["lr_max_abs"] == 0, row
    assert smoke.synth_ok(smoke.synth_scores(
        smoke.emulated_synth(crops, flips), ref))


@pytest.mark.parametrize("fault", smoke.WRONG_SYNTH)
def test_synth_limits_catch_each_wrong_kernel(fault):
    """H pass first, no quantization between the passes, the flip columns
    swapped, or a true division by 255: each fails B3's limits."""
    crops, flips = _synth_inputs()
    row = smoke.synth_scores(smoke.emulated_synth(crops, flips, fault=fault),
                             smoke.synthesize_pair(crops, flips))
    assert not smoke.synth_ok(row), row


PAIR_SHAPE = (3, 5, 10, 64)  # ragged, several images, W = 10


def _pair_inputs(dtype):
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(0, 0.5, PAIR_SHAPE).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 0.1, PAIR_SHAPE).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 0.05, (3, 3, 64, 64)).astype(
        np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, (64,)).astype(np.float32))
    return x.to(dtype), k, b, g.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pair_conv_limits_pass_the_kernels_arithmetic(dtype):
    """The kernels' arithmetic (the plain versions: f32 sums rounded once
    to x's dtype) passes B4's and B5's limits."""
    x, k, b, g = _pair_inputs(dtype)
    y = pc_ops.pair_conv_reference(x, k, b)
    row = smoke.pair_scores(x, k, b, g, y,
                            pc_ops.pair_conv_bwd_reference(x, k, g))
    assert max(row[key] for key in ("fwd", "dx", "dw", "db")) <= 1, row
    # with a zero column at each side the emulated column-mask fault
    # wraps onto zeros only: its fault is the wrap and nothing else
    masked = smoke.conv_no_column_mask(F.pad(x, (0, 0, 1, 1)), k, b)
    assert smoke.excess(masked[:, :, 1:-1], y, smoke.STAGE_LIMITS[dtype]) \
        <= 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pair_conv_limits_catch_each_wrong_kernel(dtype):
    """K transposed, no column mask, bias dropped (forward); dx with the
    unflipped kernel, one CTA's dW partial dropped (backward): each
    reads over its limit."""
    x, k, b, g = _pair_inputs(dtype)
    wrong = smoke.pair_wrong_scores(x, k, b, g)
    tf32 = [f"{p}{name}" for name in smoke.WRONG_PAIR_TF32
            for p in ("", "bwd_")] if dtype == torch.float32 else []
    assert set(wrong) == set(smoke.WRONG_PAIR_FWD + smoke.WRONG_PAIR_BWD
                             + tuple(tf32))
    assert min(wrong.values()) > 1, wrong


@pytest.mark.parametrize("shape", [PAIR_SHAPE, (4, 3, 2, 64),
                                   (2, 8, 12, 64)], ids=str)
def test_pair_conv_limits_pass_3xtf32_and_fail_plain_tf32(shape):
    """The f32 kernels' 3xTF32 arithmetic (emulated) passes B4's and
    B5's f32 limits against the plain f32 versions; plain TF32 (hi.hi
    only) and 3xTF32 with lo.hi dropped fail them, forward and dx."""
    rng = np.random.default_rng(14)
    x, g = (torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
            for s in (0.5, 0.1))
    _, k, b, _ = _pair_inputs(torch.float32)
    y = pc_ops.pair_conv_3xtf32_reference(x, k, b)
    row = smoke.pair_scores(x, k, b, g, y,
                            pc_ops.pair_conv_bwd_3xtf32_reference(x, k, g))
    assert max(row[key] for key in ("fwd", "dx", "dw", "db")) <= 1, row
    limits = smoke.STAGE_LIMITS[torch.float32]
    ref_dx = pc_ops.pair_conv_bwd_reference(x, k, g)[0]
    for terms in smoke.WRONG_PAIR_TF32.values():
        wrong_y = pc_ops.pair_conv_3xtf32_reference(x, k, b, terms)
        assert smoke.excess(wrong_y, pc_ops.pair_conv_reference(x, k, b),
                            limits) > 1
        wrong_dx = pc_ops.pair_conv_bwd_3xtf32_reference(x, k, g, terms)[0]
        assert smoke.excess(wrong_dx, ref_dx, limits) > 1


STALE_SHAPE = (133, 2, 2, 64)  # 133 one-run images: CTA 0 walks two runs


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pair_conv_limits_catch_a_stale_stage(dtype):
    """A persistent CTA that computes a run from the stage of its
    previous run reads over B4's limit; the plain arithmetic passes the
    same limit at the same shape, and the fault is only held where a CTA
    walks several runs."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(0, 0.5, STALE_SHAPE).astype(
        np.float32)).to(dtype)
    _, k, b, _ = _pair_inputs(dtype)
    ref = pc_ops.pair_conv_reference(x, k, b)
    limits = smoke.STAGE_LIMITS[dtype]
    assert smoke.multi_run(STALE_SHAPE[:3])
    assert not smoke.multi_run(PAIR_SHAPE[:3])
    assert smoke.excess(smoke.stale_stage(x, k, b), ref, limits) > 1
    assert smoke.excess(pc_ops.pair_conv_reference(x, k, b), ref,
                        limits) <= 1
    assert smoke.WRONG_PAIR_STALE in smoke.pair_wrong_scores(x, k, b, x)


def test_check_counts_names_every_counter():
    """The launch check holds every counter: one not named must be 0,
    the TORCHSR_RDB_BWD=xla one included."""
    smoke.reset_counters()
    assert set(smoke.read_counters()) == set(smoke.COUNTERS)
    assert all(hasattr(m, a) for m, a in smoke.COUNTERS.values())
    smoke.check_counts("none", smoke.read_counters())
    try:
        rdb_ops.RDB_BWD_XLA_LAUNCHES = 1
        with pytest.raises(RuntimeError, match="kernel launches"):
            smoke.check_counts("xla", smoke.read_counters())
    finally:
        smoke.reset_counters()


def test_kernels_line_reads_both_profile_shapes():
    """The kernels line takes each kernel's device time from its phase's
    profile: a backward's ``bwd_profile`` (``device_ms``) or another
    phase's ``profile_device_time`` (``device_ms_per_batch``)."""
    timed, want = {}, {}
    for i, (name, _, _, phase, key, _) in enumerate(smoke.KERNELS):
        row = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0,
               "bound_ms": 0.5, "bound_by": "operations"}
        if phase.startswith("rdb_bwd"):
            row["profile"] = {"device_ms": 0.25 + i, "kernels_per_call": 8,
                              "by_launch": [["prep", 0.25 + i]]}
            want[name] = 0.25 + i
        elif i % 2:
            row["profile"] = {"device_ms_per_batch": {"a": 0.5, "b": i}}
            want[name] = 0.5 + i
        else:
            want[name] = None
        timed.setdefault(phase, {})[key] = row
    paths = {"train": {name: 3 for name, *_ in smoke.KERNELS}}
    line = smoke.kernels_line(timed, paths)
    assert [k["name"] for k in line["kernels"]] == [
        name for name, *_ in smoke.KERNELS]
    for k in line["kernels"]:
        assert k["device_ms"] == want[k["name"]]
        assert k["library_device_ms"] is None
        assert k["launches"] == 3


def test_kernels_line_reads_each_kernels_own_counter():
    """Every kernel of the kernels line has a counter of its own: the f32
    kernels' launches are not the bf16 ones' (a path that ran bf16 B1
    only gives the f32 rows 0)."""
    names = [name for name, *_ in smoke.KERNELS]
    assert set(names) <= set(smoke.COUNTERS)
    assert len({smoke.COUNTERS[n] for n in names}) == len(names)
    timed = {}
    for _, _, _, phase, key, _ in smoke.KERNELS:
        timed.setdefault(phase, {})[key] = {
            "max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
            "bound_by": "operations"}
    counts = {name: 0 for name in smoke.COUNTERS}
    line = smoke.kernels_line(timed, {"serve": {**counts, "rdb_fwd": 345},
                                      "eval": {**counts, "rdb_fwd_f32": 5}})
    got = {k["name"]: k["launches_by_path"] for k in line["kernels"]}
    assert got["rdb_fwd"] == {"serve": 345, "eval": 0}
    assert got["rdb_fwd_f32"] == {"serve": 0, "eval": 5}
    assert got["rdb_fwd_ext_f32"] == {"serve": 0, "eval": 0}


@pytest.mark.parametrize("kernel", ["rdb_fwd", "rdb_fwd_ext"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_counter_names_the_dtypes_kernel(kernel, dtype):
    """The smoke's per-dtype forward counter is the one the wrapper of
    that dtype adds to."""
    name = smoke.fwd_counter(kernel, dtype)
    assert name in smoke.COUNTERS
    attr = smoke.COUNTERS[name][1]
    assert ("_F32_" in attr) == (dtype == torch.float32)
    assert attr.startswith("RDB_FWD_EXT" if kernel == "rdb_fwd_ext"
                           else "RDB_FWD_")


# ------------------------------------------------ eval, interp, SRGAN


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """The eval phase's images and a 1-RRDB checkpoint, scored by the
    port's ``eval`` on the CPU with the float SR of every image kept."""
    from argparse import Namespace

    from torchsr_tpu_torch.infer.evaluate import run_eval
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
    from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("smoke_eval")
    rng = np.random.default_rng(5)
    (root / "val").mkdir()
    hr = {}
    for i, hw in enumerate(smoke.EVAL_SIZES):
        hr[f"img{i}.png"] = rng.integers(0, 256, (*hw, 3), np.uint8)
        smoke._write_png(str(root / "val" / f"img{i}.png"),
                         hr[f"img{i}.png"])
    gen = ESRGANGenerator(num_rrdb_blocks=1,
                          generator=torch.Generator().manual_seed(1))
    ckpt = str(root / "g.pth")
    save_checkpoint(ckpt, 1, "gan", gen.state_dict())
    args = Namespace(image_dir=str(root / "val"), model="esrgan",
                     checkpoint=ckpt, crop=None, tile=0, tile_overlap=16,
                     tile_batch=8, bf16=False, save_sr=True, report=None,
                     device="cpu")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with smoke.saved_sr({}) as srs:
            report = run_eval(args, ESRGANGenerator)
    finally:
        os.chdir(cwd)
    return report, srs, hr, args


def test_eval_report_recomputes_in_float64_and_faults_show(eval_run):
    """The report's PSNR/SSIM equal float64 numpy's of the saved SR to
    the report's rounding; an SR one level off on a patch, or SSIM with
    a box window in place of the Gaussian, does not."""
    report, srs, hr, _ = eval_run
    smoke._check_report(report, "cpu eval")

    def box(n):
        mat = np.zeros((n - 10, n))
        for i in range(n - 10):
            mat[i, i:i + 11] = 1 / 11
        return mat

    for row in report["per_image"]:
        sr = srs[f"upres-{row['image']}"]
        got = smoke.report_excess(row, sr, hr[row["image"]])
        assert max(got["psnr"], got["ssim"]) <= 1, got
        off = sr.copy()
        off[:8, :8] += 1 / 255
        bad = smoke.report_excess(row, off, hr[row["image"]])
        assert max(bad["psnr"], bad["ssim"]) > 1, bad
        assert smoke.report_excess(row, sr, hr[row["image"]],
                                   window=box)["ssim"] > 1


def test_eval_check_sees_a_broken_skip_rule(eval_run):
    report = eval_run[0]
    broken = dict(report, images=report["images"] + 1, per_image=[
        *report["per_image"], dict(report["per_image"][0],
                                   image=smoke.EVAL_SKIPPED)])
    with pytest.raises(RuntimeError, match="skipped"):
        smoke._check_report(broken, "skip")
    nan = dict(report, per_image=[dict(report["per_image"][0],
                                       psnr=float("nan")),
                                  *report["per_image"][1:]])
    with pytest.raises(RuntimeError, match="finite"):
        smoke._check_report(nan, "nan")


@pytest.mark.parametrize("tile_args", [(), smoke.EVAL_TILE,
                                       ("--tile", "16", "--tile-batch", "3",
                                        "--tile-overlap", "4")])
def test_eval_forwards_counts_the_generator_calls(eval_run, tile_args,
                                                  monkeypatch):
    """``eval_forwards`` (B1's launches on the eval path are 5 x 69 per
    forward) counts the forwards ``eval`` runs: on the CPU, where the
    tile forward is the module itself, without the capture's warm-up
    forward that a tiled run adds on CUDA."""
    from torchsr_tpu_torch.infer import evaluate
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator

    args = eval_run[3]
    opts = dict(zip(tile_args[::2], tile_args[1::2]))
    args = type(args)(**{**vars(args), "save_sr": False,
                         "tile": int(opts.get("--tile", 0)),
                         "tile_overlap": int(opts.get("--tile-overlap", 16)),
                         "tile_batch": int(opts.get("--tile-batch", 8))})
    calls = []
    forward = ESRGANGenerator.forward
    monkeypatch.setattr(ESRGANGenerator, "forward",
                        lambda self, x: calls.append(x.shape) or
                        forward(self, x))
    evaluate.run_eval(args, ESRGANGenerator)
    assert len(calls) == smoke.eval_forwards(smoke.EVAL_SIZES, tile_args,
                                             capture=0)
    assert smoke.eval_forwards(smoke.EVAL_SIZES, tile_args) - len(calls) \
        == (smoke.CAPTURE_FORWARDS if tile_args else 0)


def test_srgan_paths_expect_no_kernel():
    """The SRGAN paths' launch check names no counter: any launch fails."""
    smoke.reset_counters()
    smoke.check_counts("srgan", smoke.read_counters())
    try:
        rdb_ops.RDB_FWD_LAUNCHES = 5
        with pytest.raises(RuntimeError, match="kernel launches"):
            smoke.check_counts("srgan", smoke.read_counters())
    finally:
        smoke.reset_counters()


# ------------------------------------------------------------ multistep


@pytest.fixture
def one_torch_thread():
    """Tiny steps run as fast on one intra-op thread, and the test
    workers that share the machine do not wait on each other's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_multistep_limits_pass_equal_steps_and_fail_the_faults(
        monkeypatch, one_torch_thread):
    """The multistep phase's noise floor and limit on the CPU, the K-step
    call standing in for the replays (on the CPU it runs the same eager
    steps): it passes; a run whose second step saw the first batch again
    (a replay without the new batch) fails, and so does a run at another
    learning rate (a rate baked in at capture)."""
    from argparse import Namespace

    from torchsr_tpu_torch.train.state import set_lr
    from torchsr_tpu_torch.train.trainer import SRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    args = Namespace(batch_size=2, seed=0, skip_image_save=True, epochs=1,
                     pretrain_epochs=1, num_residual=1, vgg_convs=2,
                     disable_amp=True, metrics_file=None)
    tr = SRGANTrainer(args, Namespace(crop_size=32), None, 1, 1,
                      device=torch.device("cpu"), logger=Logger())
    g = torch.Generator().manual_seed(3)
    crops = torch.randint(0, 256, (2, 2, 32, 32, 3), generator=g,
                          dtype=torch.uint8)
    flips = torch.randint(0, 2, (2, 2, 2), generator=g).bool()
    tr.pretrain_step_multi(crops, flips)  # the Adam state exists

    def eager(ck, fk):
        return torch.stack([tr.pretrain_step(c, f) for c, f in zip(ck, fk)])

    snap = smoke._snapshot(tr)
    res = smoke._eager_vs_graph(tr, snap, crops, flips, eager,
                                tr.pretrain_step_multi)
    assert all(v["max"] == 0 for v in res["floor"].values())
    assert smoke._within_floor(res["graph"], res["floor"])
    assert res["loss_max_diff"] == 0
    assert res["graph"]["adam"]["max"] == 0 and len(snap["adam"]) > 0
    smoke._restore_in_place(tr, snap)
    eager(crops[[0, 0]], flips[[0, 0]])
    stale = smoke._state_diff(smoke._snapshot(tr), res["eager_state"])
    assert not smoke._within_floor(stale, res["floor"])
    smoke._restore_in_place(tr, snap)
    set_lr(tr.opt.psnr, 4e-5)
    eager(crops, flips)
    other_lr = smoke._state_diff(smoke._snapshot(tr), res["eager_state"])
    assert not smoke._within_floor(other_lr, res["floor"])


@pytest.mark.parametrize("graph_mean, ok", [(0.0, True), (2e-6, True),
                                            (2.5e-6, False)])
def test_multistep_floor_is_a_mean(graph_mean, ok):
    """Where two eager runs differ, the graph may differ by up to twice
    their mean difference; where they agree, not at all."""
    floor = {"gen": {"mean": 1e-6, "max": 3e-4},
             "adam_steps": {"mean": 0.0, "max": 0.0}}
    diff = {"gen": {"mean": graph_mean, "max": 1e-3},
            "adam_steps": {"mean": 0.0, "max": 0.0}}
    assert smoke._within_floor(diff, floor) is ok
    diff["adam_steps"] = {"mean": 1e-9, "max": 1.0}
    assert not smoke._within_floor(diff, floor)


def test_bench_phase_counts_the_frames_tile_batches():
    """1080p -> 4K at tile 64, overlap 8: 20 x 35 tiles, 44 batches of
    16 (B1: 44 x 345 launches a frame); SRGAN's tile 256: 5 x 8 tiles,
    5 batches of 8."""
    assert smoke.bench_tile_batches((1080, 1920), 64, 8, 16) == 44
    assert smoke.bench_tile_batches((1080, 1920), 256, 16, 8) == 5

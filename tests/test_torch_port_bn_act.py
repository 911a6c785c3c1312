"""The SRGAN generator's fused BatchNorm (``ops/bn_act.py``) on the CPU.

The plain version (the module composition the wrapper takes on the CPU)
against a float64 restatement of the kernels' formulas
(``bn_act_formulas``): forward, dx, dweight, dbias, the slope's gradient
and the running statistics, bf16 and f32, each epilogue, training and
eval; the bf16 rounding points; the SRGAN generator bit for bit against
the module composition it ran before; what the wrapper refuses; the
launch counters (0 on the CPU, added per replay by ``train/graphs.py``);
the kernels' grid; and ``chip_smoke.py``'s limits, which must pass the
plain version and fail a dx without its mean(dz * xhat) term.
"""

import copy
import math

import pytest
import torch

import chip_smoke
from torchsr_tpu_torch.models.layers import BatchNorm, PReLU
from torchsr_tpu_torch.models.srgan import SRGANGenerator
from torchsr_tpu_torch.ops import bn_act as bn_ops
from torchsr_tpu_torch.ops import rdb as rdb_ops
from torchsr_tpu_torch.train import graphs

SHAPE = (3, 6, 5, 16)
DTYPES = (torch.bfloat16, torch.float32)
EPIS = ("prelu", "add", "none")
# Plain (f32 statistics, PyTorch's CPU sums) against float64.  f32:
# rounding of f32 arithmetic.  bf16: a value rounded to bf16 may round the
# other way at a tie (one bf16 ulp, at most 2^-7 of it), which a skip add
# carries into the sum; the sums are f32 (dslope is rounded to bf16).
LIMITS = {torch.float32: {"y": (1e-5, 1e-6), "dx": (1e-5, 1e-5),
                          "sum": (1e-5, 1e-6), "dslope": (1e-5, 1e-6),
                          "running": (1e-6, 1e-7)},
          torch.bfloat16: {"y": (2**-7, 2**-7), "dx": (2**-7, 2**-8),
                           "sum": (1e-5, 1e-6), "dslope": (2**-7, 1e-6),
                           "running": (1e-6, 1e-7)}}


# one torch thread for the module: the test workers share the cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, dtype, seed=0):
    """As ``chip_smoke.bn_act_inputs``, on the CPU."""
    device = chip_smoke.DEVICE
    chip_smoke.DEVICE = "cpu"
    try:
        return chip_smoke.bn_act_inputs(shape, dtype, seed)
    finally:
        chip_smoke.DEVICE = device


def _close(got, ref, limits) -> None:
    rel, frac = limits
    got, ref = got.double(), ref.double()
    atol = frac * ref.abs().max()
    bad = (got - ref).abs() > rel * ref.abs() + atol
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.numel()} beyond rel {rel} atol "
        f"{float(atol)}: max diff {float((got - ref).abs().max())}")


def _plain(x, skip, dy, bn, prelu, epi, train):
    return chip_smoke.bn_act_run(bn_ops.bn_act, x, skip, dy, bn, prelu, epi,
                                 train)


@pytest.mark.parametrize("train", (True, False), ids=("train", "eval"))
@pytest.mark.parametrize("epi", EPIS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_plain_matches_the_formulas(dtype, epi, train):
    x, skip, dy, bn, prelu = _inputs(SHAPE, dtype)
    got = _plain(x, skip, dy, bn, prelu, epi, train)
    state = copy.deepcopy(bn).train(train)
    ref = bn_ops.bn_act_formulas(
        x, state, slope=prelu.weight if epi == "prelu" else None,
        residual=skip if epi == "add" else None, dy=dy)
    lim = LIMITS[dtype]
    assert got["y"].dtype == got["dx"].dtype == dtype
    _close(got["y"], ref["y"], lim["y"])
    _close(got["dx"], ref["dx"], lim["dx"])
    for key in ("dweight", "dbias"):
        assert got[key].dtype == torch.float32
        _close(got[key], ref[key], lim["sum"])
    if epi == "prelu":
        assert got["dslope"].dtype == torch.float32
        assert got["dslope"].to(dtype).float().equal(got["dslope"])
        _close(got["dslope"], ref["dslope"], lim["dslope"])
    if epi == "add":
        assert got["dskip"].equal(dy)
    if train:
        _close(got["running_mean"], ref["running_mean"], lim["running"])
        _close(got["running_var"], ref["running_var"], lim["running"])
        assert got["num_batches"] == 1
    else:
        assert "running_mean" not in got


@pytest.mark.parametrize("epi", ("prelu", "add"))
def test_bf16_rounding_points_are_the_compositions(epi):
    """The plain bf16 output equals the restatement, which rounds the
    BatchNorm output to bf16 before the epilogue, at nearly every element;
    the same formulas rounding once, after the epilogue, differ at many."""
    x, skip, dy, bn, prelu = _inputs((8, 12, 12, 32), torch.bfloat16, 1)
    got = _plain(x, skip, dy, bn, prelu, epi, True)["y"]
    state = copy.deepcopy(bn)
    kw = ({"slope": prelu.weight} if epi == "prelu"
          else {"residual": skip})
    ref = bn_ops.bn_act_formulas(x, state, **kw)["y"]
    # the restatement without the inner rounding
    f = bn_ops.bn_act_formulas(x.float(), state, **{
        k: v.float() for k, v in kw.items()})["y"]
    once = f.to(torch.bfloat16)
    same = (got == ref).double().mean()
    assert same > 0.99, same
    mask = f < 0 if epi == "prelu" else torch.ones_like(f, dtype=torch.bool)
    moved = (got != once)[mask].double().mean()
    assert moved > 0.02, moved


def _old_forward(gen, x):
    """The generator as the module composition ran it before bn_act."""
    conv1 = gen.conv1(x.to(gen.compute_dtype or torch.float32))
    out = conv1
    for blk in gen.blocks:
        h = blk.prelu(blk.bn1(blk.conv1(out)))
        out = blk.bn2(blk.conv2(h)) + out
    out = conv1 + gen.conv2(out)
    return gen.tail(out).float()


@pytest.mark.parametrize("train", (True, False), ids=("train", "eval"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_srgan_generator_bit_equal_to_the_composition(dtype, train):
    gen = SRGANGenerator(num_residual=2, compute_dtype=dtype,
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.3, 0.3)
    gen.train(train)
    old = copy.deepcopy(gen)
    x = torch.rand((2, 10, 12, 3), generator=torch.Generator().manual_seed(4))
    outs, grads = [], []
    for g, fwd in ((gen, lambda m, t: m(t)), (old, _old_forward)):
        y = fwd(g, x)
        y.square().mean().backward()
        outs.append(y)
        grads.append({k: p.grad for k, p in g.named_parameters()})
    assert outs[0].equal(outs[1])
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        assert grads[0][k].equal(grads[1][k]), k
    assert all(a.equal(b) for a, b in zip(gen.state_dict().values(),
                                          old.state_dict().values()))
    assert list(gen.state_dict()) == list(old.state_dict())


def _bn(c=16):
    return BatchNorm(c)


def _unaligned():
    n = math.prod(SHAPE)
    return torch.zeros(n + 1, device="meta")[1:].view(SHAPE)


REFUSED = {
    "float16": lambda: (torch.zeros(SHAPE, dtype=torch.float16), _bn(), {}),
    "float64": lambda: (torch.zeros(SHAPE, dtype=torch.float64), _bn(), {}),
    # the layout where the kernels would run (a device that is not the
    # CPU's: the check comes before the device's)
    "nchw_view": lambda: (
        torch.zeros((3, 16, 6, 5), device="meta").permute(0, 2, 3, 1),
        _bn().to("meta"), {}),
    "residual_nchw_view": lambda: (
        torch.zeros(SHAPE, device="meta"), _bn().to("meta"), {
            "residual": torch.zeros((3, 16, 6, 5), device="meta").permute(
                0, 2, 3, 1)}),
    # an address the kernels' 16-byte vector loads cannot take (a view
    # 4 bytes into its storage)
    "x_unaligned": lambda: (_unaligned(), _bn().to("meta"), {}),
    "residual_unaligned": lambda: (
        torch.zeros(SHAPE, device="meta"), _bn().to("meta"),
        {"residual": _unaligned()}),
    "three_dims": lambda: (torch.zeros((6, 5, 16)), _bn(), {}),
    "c_not_multiple_of_8": lambda: (torch.zeros((3, 6, 5, 12)), _bn(12),
                                    {}),
    "c_over_256": lambda: (torch.zeros((1, 2, 2, 264)), _bn(264), {}),
    "c_not_the_bns": lambda: (torch.zeros(SHAPE), _bn(24), {}),
    "prelu_and_residual": lambda: (torch.zeros(SHAPE), _bn(), {
        "prelu": PReLU(), "residual": torch.zeros(SHAPE)}),
    "residual_dtype": lambda: (torch.zeros(SHAPE), _bn(), {
        "residual": torch.zeros(SHAPE, dtype=torch.bfloat16)}),
    "residual_shape": lambda: (torch.zeros(SHAPE), _bn(), {
        "residual": torch.zeros((3, 6, 5, 8))}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refuses_what_the_kernels_do_not_take(case):
    x, bn, kw = REFUSED[case]()
    with pytest.raises((TypeError, ValueError), match="bn_act takes|bn_act's"):
        bn_ops.bn_act(x, bn, **kw)


@pytest.mark.parametrize("epi", EPIS)
def test_plain_version_takes_any_layout_on_the_cpu(epi):
    """The CPU runs the composition, which takes any strides: NCHW views
    give the composition's values on them."""
    x, skip, _, bn, prelu = _inputs(SHAPE, torch.float32)

    def nchw(t):
        return t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    kw = {"prelu": prelu} if epi == "prelu" else (
        {"residual": nchw(skip)} if epi == "add" else {})
    view = nchw(x)
    got = bn_ops.bn_act(view, copy.deepcopy(bn), **kw)
    ref = bn_ops.bn_act_reference(view, copy.deepcopy(bn), **kw)
    assert not view.is_contiguous() and got.equal(ref)


def test_refuses_a_device_without_kernels():
    with pytest.raises(ValueError, match="CUDA"):
        bn_ops.bn_act(torch.zeros(SHAPE, device="meta"),
                      _bn().to("meta"))


def test_counters_stay_zero_on_the_cpu():
    for name in bn_ops.LAUNCH_COUNTERS:
        setattr(bn_ops, name, 0)
    gen = SRGANGenerator(num_residual=1,
                         generator=torch.Generator().manual_seed(0))
    gen(torch.rand((2, 8, 8, 3))).sum().backward()
    with rdb_ops.plain_forward():
        gen.eval()(torch.rand((1, 8, 8, 3)))
    assert {n: getattr(bn_ops, n) for n in bn_ops.LAUNCH_COUNTERS} == {
        n: 0 for n in bn_ops.LAUNCH_COUNTERS}


def test_replay_accounting_adds_the_bn_counters():
    """``train/graphs.py`` reads and adds bn_act's counters beside the
    RDB ones: what a captured SRGAN pretrain step adds per replay."""
    counts = graphs.launch_counts()
    assert set(bn_ops.LAUNCH_COUNTERS) <= set(counts)
    assert set(rdb_ops.LAUNCH_COUNTERS) <= set(counts)
    saved = {n: getattr(bn_ops, n) for n in bn_ops.LAUNCH_COUNTERS}
    rdb_saved = {n: getattr(rdb_ops, n) for n in rdb_ops.LAUNCH_COUNTERS}
    try:
        for n in bn_ops.LAUNCH_COUNTERS:
            setattr(bn_ops, n, 0)
        step = {n: 0 for n in counts}
        step.update(BN_ACT_FWD_LAUNCHES=33, BN_ACT_BWD_LAUNCHES=33)
        graphs.add_launch_counts(step, times=8)
        assert bn_ops.BN_ACT_FWD_LAUNCHES == bn_ops.BN_ACT_BWD_LAUNCHES \
            == 264
        assert bn_ops.BN_ACT_FWD_F32_LAUNCHES == 0
        assert {n: getattr(rdb_ops, n) for n in rdb_ops.LAUNCH_COUNTERS} \
            == rdb_saved
    finally:
        for n, v in saved.items():
            setattr(bn_ops, n, v)


@pytest.mark.parametrize("rows,c", [(73_728, 64), (1, 8), (100, 256),
                                    (524_288, 64), (37, 24), (4_099, 64)])
def test_grid_covers_every_row_once(rows, c):
    ctas, rpb = bn_ops.bn_act_grid(rows, c)
    assert 1 <= ctas <= bn_ops._CTAS
    assert (ctas - 1) * rpb < rows <= ctas * rpb
    owned = sum(max(0, min(rows, (b + 1) * rpb) - b * rpb)
                for b in range(ctas))
    assert owned == rows


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
def test_smoke_limits_pass_the_plain_version_and_see_the_fault(dtype):
    """``chip_smoke.py``'s scores: the plain version against the float64
    formulas inside ``BN_ACT_LIMITS``, the formulas without the
    mean(dz * xhat) term of dx over them."""
    x, skip, dy, bn, prelu = _inputs((16, 24, 24, 64), dtype, 2)
    for epi in EPIS:
        kw = {"slope": prelu.weight if epi == "prelu" else None,
              "residual": skip if epi == "add" else None}
        got = _plain(x, skip, dy, bn, prelu, epi, True)
        state = copy.deepcopy(bn)
        f64 = bn_ops.bn_act_formulas(x, state, dy=dy, **kw)
        scores = chip_smoke.bn_act_scores(got, f64, f64, dtype)
        assert max(scores.values()) <= 1, (epi, scores)
        wrong = bn_ops.bn_act_formulas(x, state, dy=dy, drop="dzx", **kw)
        assert chip_smoke.bn_act_scores(wrong, f64, f64, dtype)["dx"] > 1

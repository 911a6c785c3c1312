"""HAT's residual adds and LayerNorm (``ops/add_ln.py``) on the CPU.

The plain version against a float64 restatement (the adds rounded where
the composition rounds them, the statistics in float64) within
``chip_smoke.py``'s limits, which a dropped term reads over; what the
kernel path refuses, checked on CPU tensors before any launch; and the HAT
generator, whose trunk now carries its residual stream as ``(x,
pending)``, equal bit for bit to the module composition in
``hat_arch.py``'s order (written out here) at a tiny size, in f32 and
bf16, with the terms it folds in counted.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from port_bench import weights
from port_bench.reference import hat as ref
from torchsr_tpu_torch.models.hat import HATGenerator
from torchsr_tpu_torch.ops import add_ln
from torchsr_tpu_torch.ops import window_attn as wa
from torchsr_tpu_torch.ops.pixel_shuffle import depth_to_space

ROOT = Path(__file__).resolve().parents[1]
CFG = {**json.loads((ROOT / "port_bench/configs/hat.json").read_text()),
       "embed_dim": 24, "depths": [2, 2], "num_heads": [2, 2],
       "window_size": 4, "compress_ratio": 3, "squeeze_factor": 6}
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _restated(x, terms, scales, weight, bias, eps=1e-5):
    """The stream rounded to x's dtype after each product and each add,
    the LayerNorm in float64; returns float64 tensors."""
    s = x.double()
    for t, sc in zip(terms, scales):
        s = (s + (t.double() * sc).to(x.dtype).double()).to(x.dtype).double()
    mean = s.mean(-1, keepdim=True)
    var = ((s - mean) ** 2).mean(-1, keepdim=True)
    normed = (s - mean) / torch.sqrt(var + eps) * weight.double() \
        + bias.double()
    return s, normed


# ------------------------------------------------------------ plain version


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("shape", [(3, 5, 180), (7, 12), (1, 3, 3, 180)],
                         ids=("15x180", "7x12", "9x180"))
@pytest.mark.parametrize("scales", [(), (1.0,), (0.01,), (1.0, 0.01),
                                    (1.0, 1.0)],
                         ids=("none", "one", "one-scaled", "two-scaled",
                              "two"))
def test_plain_against_the_float64_restatement(dtype, shape, scales):
    x, terms, weight, bias = chip_smoke.add_ln_inputs(
        shape, dtype, len(scales), 3 + len(scales), device="cpu")
    got = add_ln.add_layer_norm(x, terms, scales, weight=weight, bias=bias)
    want = _restated(x, terms, scales, weight, bias)
    assert got[0].dtype == got[1].dtype == dtype
    assert got[0].shape == got[1].shape == x.shape
    scores = chip_smoke.add_ln_scores(got, want, dtype)
    assert max(scores.values()) <= 1, scores
    if dtype == torch.bfloat16:
        # the composition's roundings: the stream is exact
        assert torch.equal(got[0].double(), want[0])
    wrong = chip_smoke.add_ln_scores(
        chip_smoke.add_ln_wrong(x, terms, scales, weight, bias), want, dtype)
    assert wrong["normed"] > 1, wrong


def test_no_terms_keeps_x_as_the_stream():
    x, _, weight, bias = chip_smoke.add_ln_inputs((4, 8), torch.float32, 0,
                                                  1, device="cpu")
    stream, normed = add_ln.add_layer_norm(x, weight=weight, bias=bias)
    assert stream is x
    torch.testing.assert_close(
        normed, F.layer_norm(x, (8,), weight, bias, 1e-5), rtol=0, atol=0)


def test_counters_on_the_cpu():
    """Terms count on either version, launches only on the kernel."""
    x, terms, weight, bias = chip_smoke.add_ln_inputs((4, 8), torch.float32,
                                                      2, 1, device="cpu")
    before = {n: getattr(add_ln, n) for n in add_ln.LAUNCH_COUNTERS}
    add_ln.add_layer_norm(x, terms, weight=weight, bias=bias)
    add_ln.add_layer_norm(x, terms[:1], weight=weight, bias=bias)
    assert {n: getattr(add_ln, n) - before[n]
            for n in add_ln.LAUNCH_COUNTERS} == {"ADD_LN_LAUNCHES": 0,
                                                 "ADD_LN_TERMS": 3}


# ------------------------------------------------------------ refusals


def test_refusals_of_either_version():
    x = torch.zeros(3, 8)
    w = torch.ones(8)
    with pytest.raises(ValueError, match="terms must match"):
        add_ln.add_layer_norm(x, (torch.zeros(3, 4),), weight=w, bias=w)
    with pytest.raises(ValueError, match="terms must match"):
        add_ln.add_layer_norm(x, (x.bfloat16(),), weight=w, bias=w)
    with pytest.raises(ValueError, match="at most 2 terms"):
        add_ln.add_layer_norm(x, (x, x, x), weight=w, bias=w)
    with pytest.raises(ValueError, match="1 terms but 2 scales"):
        add_ln.add_layer_norm(x, (x,), (1.0, 1.0), weight=w, bias=w)
    with pytest.raises(ValueError, match=r"weight and bias must be \(8,\)"):
        add_ln.add_layer_norm(x, weight=torch.ones(4), bias=w)
    with pytest.raises(ValueError, match="CUDA"):
        add_ln.add_layer_norm(x.to("meta"), weight=w.to("meta"),
                              bias=w.to("meta"))


def test_kernel_path_refusals():
    """What the CUDA wrapper refuses, checked on CPU tensors (the checks
    run before any launch): f32 names the missing f32 kernel; a
    non-contiguous input or term, a C that is no multiple of 4 or is
    above 512, and a bf16 weight are refused."""
    x = torch.zeros(4, 180, dtype=torch.bfloat16)
    w = torch.ones(180)
    with pytest.raises(NotImplementedError, match="f32 form"):
        add_ln._kernel_checks(x.float(), (), w, w)
    with pytest.raises(TypeError, match="bfloat16"):
        add_ln._kernel_checks(x.half(), (), w, w)
    wide = torch.zeros(180, 4, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match="contiguous"):
        add_ln._kernel_checks(wide, (), w, w)
    with pytest.raises(ValueError, match="contiguous"):
        add_ln._kernel_checks(x, (torch.zeros(180, 4,
                                              dtype=torch.bfloat16).t(),),
                              w, w)
    for c in (6, 2, 516):
        with pytest.raises(ValueError, match="multiple of 4"):
            add_ln._kernel_checks(torch.zeros(4, c, dtype=torch.bfloat16),
                                  (), torch.ones(c), torch.ones(c))
    with pytest.raises(ValueError, match="f32 weight"):
        add_ln._kernel_checks(x, (), w.bfloat16(), w)
    add_ln._kernel_checks(x, (x, x), w, w)  # HAT's own form passes


# ------------------------------------------------------------ HAT


def _ln(norm, t):
    return F.layer_norm(t.float(), norm.weight.shape, norm.weight,
                        norm.bias, 1e-5).to(t.dtype)


def _hab(blk, x):
    """hat_arch.py's HAB.forward: each LayerNorm on its own, the adds
    where it makes them."""
    n = _ln(blk.norm1, x)
    conv = blk.conv_block(n)
    attn = blk.attn
    a = wa.window_attn(attn.qkv(n), attn.relative_position_bias_table,
                       heads=attn.heads, window=attn.window, shift=blk.shift)
    x = x + attn.proj(a) + conv * blk.conv_scale
    return x + blk.mlp(_ln(blk.norm2, x))


def _ocab(blk, x):
    """hat_arch.py's OCAB.forward."""
    a = wa.overlap_attn(blk.qkv(_ln(blk.norm1, x)),
                        blk.relative_position_bias_table, heads=blk.heads,
                        window=blk.window, overlap=blk.overlap)
    x = x + blk.proj(a)
    return x + blk.mlp(_ln(blk.norm2, x))


def _composed(gen, x):
    """hat_arch.py's HAT.forward over the port's modules (the map a
    whole number of windows)."""
    mean = gen.rgb_mean
    x = ((x.float() - mean) * gen.img_range).to(gen.compute_dtype
                                               or torch.float32)
    feat = gen.conv_first(x)
    t = _ln(gen.patch_embed.norm, feat)
    for layer in gen.layers:
        g = layer.residual_group
        y = t
        for blk in g.blocks:
            y = _hab(blk, y)
        t = t + layer.conv(_ocab(g.overlap_attn, y))
    t = gen.conv_after_body(_ln(gen.norm, t)) + feat
    t = F.leaky_relu(gen.conv_before_upsample["0"](t), 0.01)
    for k in range(len(gen.upsample)):
        t = depth_to_space(gen.upsample[str(2 * k)](t), 2)
    return gen.conv_last(t).float() / gen.img_range + mean


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_hat_stream_equals_the_composition(dtype):
    """The generator with its (x, pending) stream against hat_arch.py's
    order of the same modules: the same operations in the same order, so
    bit for bit; the terms folded in counted (16 at depths [2, 2]: 3 a
    HAB, 2 an OCAB, none at the first norm1, one at the final norm)."""
    w = weights.make(ref.generator_specs(CFG), 13, "generator", "cpu")
    gen = HATGenerator.sized_to(w, compute_dtype=dtype)
    weights.load_into(gen, w)
    gen.eval().requires_grad_(False)
    x = torch.rand((2, 16, 16, 3),
                   generator=torch.Generator().manual_seed(4))
    before = {n: getattr(add_ln, n) for n in add_ln.LAUNCH_COUNTERS}
    with torch.no_grad():
        got = gen(x)
        delta = {n: getattr(add_ln, n) - before[n]
                 for n in add_ln.LAUNCH_COUNTERS}
        want = _composed(gen, x)
    assert torch.equal(got, want)
    assert float(want.std()) > 0.01
    terms = sum(3 * d + 2 for d in gen.depths)
    assert delta == {"ADD_LN_LAUNCHES": 0, "ADD_LN_TERMS": terms} == {
        "ADD_LN_LAUNCHES": 0, "ADD_LN_TERMS": 16}


def test_srx4_counts_match_the_smoke():
    """The smoke's per-batch counts are HAT SRx4's: 86 calls, 120 terms."""
    gen = HATGenerator(device="meta")
    norms = sum(isinstance(m, type(gen.norm)) for m in gen.modules())
    assert norms == chip_smoke.HAT_ADD_LN_CALLS == 86
    assert sum(3 * d + 2 for d in gen.depths) \
        == chip_smoke.HAT_ADD_LN_TERMS == 120

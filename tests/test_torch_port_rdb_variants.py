"""The port's RDB layout variants against the JAX package's kernels.

``TORCHSR_RDB_EXT`` (row-extended forward and backward) and
``TORCHSR_RDB_ILV`` (chunk-interleaved forward) select the same kernels in
both packages; tests flip the module flags ``EXT_KERNEL``,
``ILV_KERNEL`` and ``BWD_XLA`` on both, and restore them (and clear
JAX's caches, which do not key on them) in ``finally``.  On the CPU the
port runs the plain versions of the layouts (``rdb_ext_reference``,
``rdb_bwd_ext_reference``, ``rdb_ilv_reference``); the JAX side runs the
Pallas kernels in interpret mode, as tests/test_pallas_rdb.py does.  The
CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.  Inputs come from numpy with a seed.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.models.esrgan import ESRGANGenerator as JaxGenerator
from torchsr_tpu.models.esrgan import ResidualDenseBlock as JaxRDB
from torchsr_tpu.ops.pallas import rdb as jax_rdb
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.ops import rdb as rdb_ops

# f32 on both sides, summed in other orders: the JAX ext test's own
# tolerance (tests/test_pallas_rdb.py:306), rtol and atol 1e-5.
TOL = 1e-5
# The interleaved plain version against the port's slot plain version
# (F.conv2d), both f32: the limit tests/test_pallas_rdb.py:454 holds the
# ilv kernel to against the slot kernel.
ATOL_ILV_SLOT = 5e-7
# Limits on max|port - jax| / max|jax| per gradient tensor, both fed
# the same feature buffer.  f32: as in tests/test_torch_port_rdb_bwd.py
# (measured 6.1e-7 here).  bf16: the dense gradient is summed in f32 in
# another order on each side, and a value that lands on the other side
# of a bf16 rounding step rounds the next conv's dy one step (2^-8)
# apart; one such element put dW_1 3.0e-5 apart here (the JAX package's
# own ext and slot backwards also part by more than 1e-5 on this
# buffer), so the limit is above tests/test_torch_port_rdb_bwd.py's.
REL_SAME_FEAT = {"float32": 1e-5, "bfloat16": 1e-4}


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    params = JaxRDB().init(jax.random.PRNGKey(seed), jnp.asarray(x))
    ks = [np.asarray(params["params"][f"conv{i}"]["conv"]["kernel"])
          for i in range(1, 6)]
    # nonzero biases, so pad-row or cross-image leakage shows
    bs = [rng.normal(0, 0.1, (k.shape[-1],)).astype(np.float32)
          for k in ks]
    g = rng.normal(0, 1, shape).astype(np.float32)
    return x, ks, bs, g


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@contextlib.contextmanager
def knobs(ext=False, ilv=False, bwd_xla=False):
    """Set the three flags on both packages; restore them after."""
    names = ("EXT_KERNEL", "ILV_KERNEL", "BWD_XLA")
    saved = [(m, n, getattr(m, n)) for m in (jax_rdb, rdb_ops)
             for n in names]
    try:
        for m in (jax_rdb, rdb_ops):
            for n, v in zip(names, (ext, ilv, bwd_xla)):
                setattr(m, n, v)
        jax.clear_caches()
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)
        jax.clear_caches()


def _jax_grads(x, ks, bs, g, dtype=jnp.float32):
    gx, gk, gb = jax.grad(
        lambda x, ks, bs: jnp.sum(
            jax_rdb.fused_rdb(x, ks, bs, interpret=True)
            .astype(jnp.float32) * g),
        argnums=(0, 1, 2),
    )(jnp.asarray(x, dtype), [jnp.asarray(k) for k in ks],
      [jnp.asarray(b) for b in bs])
    return [np.asarray(a, np.float32) for a in (gx, *gk, *gb)]


def _port_grads(x, ks, bs, g, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    kt = [torch.from_numpy(k).requires_grad_() for k in ks]
    bt = [torch.from_numpy(b).requires_grad_() for b in bs]
    out = rdb_ops.fused_rdb(xt, kt, bt)
    grads = torch.autograd.grad(out, [xt, *kt, *bt],
                                torch.from_numpy(g).to(dtype))
    return [t.float().numpy() for t in grads]


def _rel(got, want):
    return [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in zip(got, want)]


EXT_SHAPE = (2, 6, 16, 64)  # eligible: W % 16 == 0, H * W <= 4096


def test_ext_forward_matches_jax_ext():
    x, ks, bs, _ = _weights(EXT_SHAPE, 7)
    with knobs(ext=True):
        assert jax_rdb._ext_eligible(6 * 16, 16)
        assert rdb_ops._ext_eligible(6 * 16, 16)
        want = np.asarray(jax_rdb.fused_rdb(jnp.asarray(x), ks, bs,
                                            interpret=True))
        got = rdb_ops.fused_rdb(torch.from_numpy(x), _t(ks), _t(bs))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    out, buf = rdb_ops.rdb_ext_reference(torch.from_numpy(x), _t(ks),
                                         _t(bs))
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    assert buf.shape == (2, 8, 16, rdb_ops.FEAT)
    assert not buf[:, 0].any() and not buf[:, -1].any()  # pad rows zero


def test_ext_gradients_match_jax_ext():
    x, ks, bs, g = _weights(EXT_SHAPE, 8)
    with knobs(ext=True):
        want = _jax_grads(x, ks, bs, g)
        got = _port_grads(x, ks, bs, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ext_backward_on_the_same_feature_buffer(dtype):
    """``rdb_bwd_ext_reference`` against the JAX backward rule with the
    knob set (``_rdb_bwd_kernel_ext`` in interpret mode), both fed the
    feature buffer the JAX forward saved (padded here with the two zero
    rows per image the port's buffer carries)."""
    x, ks, bs, g = _weights(EXT_SHAPE, 9)
    jdt = jnp.dtype(dtype)
    with knobs(ext=True):
        _, residuals = jax_rdb._fused_rdb_fwd(
            jnp.asarray(x, jdt), tuple(jnp.asarray(k) for k in ks),
            tuple(jnp.asarray(b) for b in bs), 0.2, True)
        dx, dks, dbs = jax_rdb._fused_rdb_bwd(0.2, True, residuals,
                                              jnp.asarray(g, jdt))
    want = [np.asarray(a, np.float32) for a in (dx, *dks, *dbs)]
    feat = np.asarray(residuals[0].astype(jnp.float32)).reshape(
        *EXT_SHAPE[:3], rdb_ops.FEAT)
    tdt = getattr(torch, dtype)
    padded = torch.nn.functional.pad(torch.from_numpy(feat),
                                     (0, 0, 0, 0, 1, 1)).to(tdt)
    got_dx, got_dw, got_db, dfeat = rdb_ops.rdb_bwd_ext_reference(
        torch.from_numpy(g).to(tdt), padded, _t(ks), 0.2,
        return_dfeat=True)
    got = [t.float().numpy() for t in (got_dx, *got_dw, *got_db)]
    assert max(_rel(got, want)) <= REL_SAME_FEAT[dtype], _rel(got, want)
    # the padded dense gradient's data rows are the slot backward's
    ref = rdb_ops.rdb_bwd_reference(torch.from_numpy(g).to(tdt),
                                    padded[:, 1:-1], _t(ks), 0.2,
                                    return_dfeat=True)[3]
    torch.testing.assert_close(dfeat[:, 1:-1], ref, rtol=1e-5, atol=1e-5)
    assert dfeat[:, 0].abs().max() > 0  # out-of-image parts land there


ILV_SHAPE = (3, 5, 9, 64)  # odd width, several images


def test_ilv_forward_matches_jax_ilv():
    x, ks, bs, _ = _weights(ILV_SHAPE, 11)
    with knobs(ilv=True):
        want = np.asarray(jax_rdb.fused_rdb(jnp.asarray(x), ks, bs,
                                            interpret=True))
        kt, bt = _t(ks), _t(bs)
        for p in (*kt, *bt):  # parameters that require grad, no_grad
            p.requires_grad_()
        with torch.no_grad():
            got = rdb_ops.fused_rdb(torch.from_numpy(x), kt, bt)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    out, buf = rdb_ops.rdb_ilv_reference(torch.from_numpy(x), _t(ks),
                                         _t(bs))
    np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    slot = rdb_ops.rdb_reference(torch.from_numpy(x), _t(ks), _t(bs))
    np.testing.assert_allclose(out.numpy(), slot.numpy(), rtol=0,
                               atol=ATOL_ILV_SLOT)
    # [up | mid | dn] of x's first chunk: the rows above / below
    up, mid, dn = (buf[..., rdb_ops.ilv_columns(0, p)] for p in range(3))
    xs = torch.from_numpy(x)[..., :32]
    assert torch.equal(mid, xs)
    assert torch.equal(up[:, 1:], xs[:, :-1]) and not up[:, 0].any()
    assert torch.equal(dn[:, :-1], xs[:, 1:]) and not dn[:, -1].any()


@pytest.mark.parametrize("ci", rdb_ops.CIN)
def test_packings_equal_jax_bit_for_bit(ci):
    co = 64 if ci == 192 else 32
    k = np.random.default_rng(ci).normal(size=(3, 3, ci, co)).astype(
        np.float32)
    kt = torch.from_numpy(k)
    packed = jax_rdb.pack_kernel(jnp.asarray(k))
    assert np.array_equal(rdb_ops.pack_kernel(kt).numpy(),
                          np.asarray(packed))
    assert np.array_equal(rdb_ops.pack_kernel_t(kt).numpy(),
                          np.asarray(jax_rdb.pack_kernel_t(jnp.asarray(k))))
    assert np.array_equal(
        rdb_ops.repack_ilv(rdb_ops.pack_kernel(kt), ci).numpy(),
        np.asarray(jax_rdb._repack_ilv(packed, ci)))
    assert torch.equal(
        rdb_ops.unpack_kernel(rdb_ops.pack_kernel(kt), ci, co), kt)


_JAX_FWD = {"_rdb_fwd_kernel": "slot", "_rdb_fwd_kernel_ext": "ext",
            "_rdb_fwd_kernel_ilv": "ilv"}
_JAX_BWD = {"_rdb_bwd_kernel": "slot", "_rdb_bwd_kernel_ext": "ext"}
_PORT_FWD = {"_rdb_plain": "slot", "rdb_ext_reference": "ext",
             "rdb_ilv_reference": "ilv"}
_PORT_BWD = {"rdb_bwd_reference": "slot", "rdb_bwd_ext_reference": "ext"}


def _spy(monkeypatch, module, names, seen, key):
    for name, variant in names.items():
        fn = getattr(module, name)

        def spy(*a, _fn=fn, _v=variant, **kw):
            seen[key].append(_v)
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, spy)


# (H, W, EXT, ILV, mode) -> the variant of the forward (and backward).
# mode: "grad" (differentiated), "no_grad" (parameters require grad,
# torch.no_grad; a plain JAX call), "plain" (nothing requires grad).
ROUTES = [
    (4, 16, True, False, "grad", "ext", "ext"),
    (4, 16, True, False, "no_grad", "ext", None),
    (4, 16, True, True, "plain", "ext", None),   # ext over ilv
    (4, 16, True, True, "grad", "ext", "ext"),
    (4, 45, True, False, "grad", "slot", "slot"),  # W % 16: B1
    (4, 45, True, True, "no_grad", "ilv", None),
    (4, 45, False, True, "no_grad", "ilv", None),
    (4, 45, False, True, "grad", "slot", "slot"),
    (65, 64, True, False, "grad", "slot", "slot"),  # H * W > 4096
    (4, 16, False, False, "plain", "slot", None),
]


@pytest.mark.parametrize("h, w, ext, ilv, mode, fwd, bwd", ROUTES,
                         ids=lambda v: str(v))
def test_routing_matches_jax(monkeypatch, h, w, ext, ilv, mode, fwd, bwd):
    """The port picks the variant ``_rdb_fwd`` / ``_rdb_bwd`` pick: the
    JAX side is traced (``jax.eval_shape``) with spies on its kernel
    functions, the port runs with spies on its plain versions."""
    x, ks, bs, g = _weights((1, h, w, 64), 3)
    seen = {"jax_fwd": [], "jax_bwd": [], "fwd": [], "bwd": []}
    _spy(monkeypatch, jax_rdb, _JAX_FWD, seen, "jax_fwd")
    _spy(monkeypatch, jax_rdb, _JAX_BWD, seen, "jax_bwd")
    _spy(monkeypatch, rdb_ops, _PORT_FWD, seen, "fwd")
    _spy(monkeypatch, rdb_ops, _PORT_BWD, seen, "bwd")
    with knobs(ext=ext, ilv=ilv):
        args = (jnp.asarray(x), [jnp.asarray(k) for k in ks],
                [jnp.asarray(b) for b in bs])
        if mode == "grad":
            jax.eval_shape(jax.grad(lambda x, ks, bs: jnp.sum(
                jax_rdb.fused_rdb(x, ks, bs, interpret=True) * g)), *args)
        else:
            jax.eval_shape(lambda x, ks, bs: jax_rdb.fused_rdb(
                x, ks, bs, interpret=True), *args)
        xt, kt, bt = torch.from_numpy(x), _t(ks), _t(bs)
        if mode != "plain":
            for p in (*kt, *bt):
                p.requires_grad_()
        if mode == "grad":
            rdb_ops.fused_rdb(xt, kt, bt).sum().backward()
        else:
            with torch.no_grad():
                rdb_ops.fused_rdb(xt, kt, bt)
    assert seen["jax_fwd"] == [fwd] and seen["fwd"] == [fwd], seen
    want_bwd = [] if bwd is None else [bwd]
    assert seen["jax_bwd"] == want_bwd and seen["bwd"] == want_bwd, seen


def test_backward_follows_the_forward_not_the_knob():
    """A knob flipped between the forward and the backward does not pair
    the row-extended forward with the slot backward."""
    x, ks, bs, g = _weights(EXT_SHAPE, 5)
    xt = torch.from_numpy(x).requires_grad_()
    with knobs(ext=True):
        out = rdb_ops.fused_rdb(xt, _t(ks), _t(bs))
    with knobs(ext=False):
        (dx,) = torch.autograd.grad(out, [xt], torch.from_numpy(g))
    with knobs(ext=False):
        want = _port_grads(x, ks, bs, g)[0]
    np.testing.assert_allclose(dx.numpy(), want, rtol=TOL, atol=TOL)


def test_bwd_xla_matches_jax_bwd_xla():
    """``TORCHSR_RDB_BWD=xla``: the port's backward is
    ``rdb_bwd_reference`` from the saved buffer, held against the JAX
    package's ``_rdb_bwd_xla`` under the same knob, with the ext forward
    too (its padded buffer is cut to the data rows)."""
    x, ks, bs, g = _weights(EXT_SHAPE, 12)
    for ext in (False, True):
        with knobs(ext=ext, bwd_xla=True):
            want = _jax_grads(x, ks, bs, g)
            got = _port_grads(x, ks, bs, g)
        assert max(_rel(got, want)) <= REL_SAME_FEAT["float32"], \
            _rel(got, want)
    assert rdb_ops.RDB_BWD_XLA_LAUNCHES == 0  # counted on CUDA only


@pytest.fixture(scope="module")
def jax_generator():
    gen = JaxGenerator(num_rrdb_blocks=2, fused_rdb=True,
                       pallas_interpret=True)
    x = np.random.default_rng(0).random((2, 6, 16, 3), dtype=np.float32)
    variables = gen.init(jax.random.PRNGKey(11), jnp.asarray(x),
                         train=False)
    return gen, jax.tree.map(np.asarray, dict(variables)), x


@pytest.mark.parametrize("knob", ["ext", "ilv"])
def test_generator_matches_jax_under_each_knob(jax_generator, knob):
    """The 2-RRDB generator (W = 16: ext-eligible) with each knob, against
    the JAX generator with ``fused_rdb=True, pallas_interpret=True`` and
    the same knob."""
    gen_j, variables, x = jax_generator
    gen = ESRGANGenerator(num_rrdb_blocks=2, device="meta")
    gen.load_state_dict(from_jax_variables(variables), assign=True)
    seen = []
    with knobs(ext=knob == "ext", ilv=knob == "ilv"):
        want = np.asarray(gen_j.apply(variables, jnp.asarray(x),
                                      train=False))
        assert rdb_ops._variant(torch.zeros((1, 6, 16, 64)), ()) == knob
        with torch.no_grad():
            got = gen(torch.from_numpy(x))
        seen.append(rdb_ops._variant(torch.zeros((1, 6, 16, 64)), ()))
    assert seen == [knob]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_pretrain_step_matches_jax_under_ext():
    """One pretrain step (1 RRDB, crop 64 so the LR crops are 16 x 16 and
    ext-eligible, batch 2, f32) with the ext kernels on both sides,
    against the JAX trainer forced onto its Pallas RDB in interpret mode
    (the method of tests/test_torch_port_train_step.py)."""
    import test_torch_port_train_step as ts
    from torchsr_tpu.data.synthetic import (
        SyntheticEvalLoader,
        SyntheticTrainLoader,
    )
    from torchsr_tpu.models.torch_compat import convert_esrgan_generator
    from torchsr_tpu.parallel.mesh import (
        DistributedContext,
        make_mesh,
        replicate,
    )
    from torchsr_tpu.train.trainer import ESRGANTrainer as JaxTrainer
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    crop, batch = 64, ts.BATCH
    rng = np.random.default_rng(4)
    crops = rng.integers(0, 256, (batch, crop, crop, 3), dtype=np.uint8)
    flips = np.array([[True, False], [False, True]])
    seen = []
    with knobs(ext=True):
        jt = JaxTrainer(
            ts._args(fused_rdb=True, pallas_interpret=True),
            SyntheticTrainLoader(batch, crop, n_batches=1),
            SyntheticEvalLoader(batch, crop, n_batches=1), 1, 1,
            make_mesh(num_devices=1), DistributedContext(1, -1, -1, 1, False))
        host = jax.device_get(jt.state)
        state, loss_j = jt.pretrain_step(replicate(host, jt.mesh),
                                         *jt._put(crops, flips))
        pt = ESRGANTrainer(ts._args(), types.SimpleNamespace(crop_size=crop),
                           None, 1, 1, device=torch.device("cpu"),
                           logger=Logger())
        pt.gen.load_state_dict(from_jax_variables(
            {"params": ts._np(host.gen_params)}))
        loss = pt.pretrain_step(torch.from_numpy(crops),
                                torch.from_numpy(flips))
        seen.append(rdb_ops._variant(torch.zeros((batch, 16, 16, 64)), ()))
    assert seen == ["ext"]
    np.testing.assert_allclose(float(loss), float(loss_j),
                               rtol=ts.RTOL_LOSS)
    ts._assert_params_close(
        jax.device_get(state.gen_params),
        convert_esrgan_generator(pt.gen.state_dict())["params"],
        ts._grads(pt.gen, convert_esrgan_generator), ts.NOISE_GEN,
        "generator")


@pytest.mark.parametrize("fn", ["rdb_fwd_ext_cuda", "rdb_bwd_ext_cuda",
                                "rdb_fwd_ilv_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    x, ks, bs, g = _weights((1, 4, 16, 64), 1)
    x, ks, bs, g = (torch.from_numpy(x), _t(ks), _t(bs),
                    torch.from_numpy(g))
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "rdb_bwd_ext_cuda":
            rdb_ops.rdb_bwd_ext_cuda(
                g, torch.zeros((1, 6, 16, rdb_ops.FEAT)), ks)
        else:
            getattr(rdb_ops, fn)(x, ks, bs)

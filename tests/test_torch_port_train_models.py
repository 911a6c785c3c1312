"""The port's discriminator and VGG19 trunk against the JAX package's.

The JAX modules are initialised from fixed keys; their variables cross
to the port through ``from_jax_variables`` (including the fc1 HWC -> CHW
permutation); both run the same numpy inputs in f32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.models import ESRGANDiscriminator as JaxDisc
from torchsr_tpu.models import VGG19Features as JaxVGG
from torchsr_tpu.models.torch_compat import convert_esrgan_discriminator
from torchsr_tpu_torch.models.esrgan import ESRGANDiscriminator
from torchsr_tpu_torch.models.torch_compat import from_jax_variables
from torchsr_tpu_torch.models.vgg import VGG19Features, load_vgg19_state_dict

CROP = 32
# f32 through ten convs, nine BatchNorms and two dense layers, summed in
# other orders (measured ~1e-6 of the logits).
ATOL_DISC = 5e-5
# the BatchNorm running statistics after one train-mode forward
ATOL_STATS = 1e-5
# f32 through up to four convs (measured ~1e-7)
ATOL_VGG = 1e-5


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def jax_disc():
    disc = JaxDisc(image_size=CROP)
    rng = np.random.default_rng(1)
    x = rng.random((3, CROP, CROP, 3)).astype(np.float32)
    variables = _np_tree(dict(disc.init(jax.random.PRNGKey(3),
                                        jnp.asarray(x), train=False)))
    # non-trivial running statistics, so eval mode is exercised
    for name, bn in variables["batch_stats"].items():
        c = bn["bn"]["mean"].shape[0]
        bn["bn"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        bn["bn"]["var"] = (0.5 + rng.random(c)).astype(np.float32)
    return disc, variables, x


def _port_disc(variables, **kw):
    disc = ESRGANDiscriminator(image_size=CROP, **kw)
    disc.load_state_dict(from_jax_variables(variables))
    return disc


def test_discriminator_state_dict_uses_reference_keys():
    sd = ESRGANDiscriminator(image_size=CROP).state_dict()
    convs = (0, 2, 5, 8, 11, 14, 17, 20, 23, 26)
    bns = (3, 6, 9, 12, 15, 18, 21, 24, 27)
    want = {"features.0.bias", "classifier.0.weight", "classifier.0.bias",
            "classifier.2.weight", "classifier.2.bias"}
    want |= {f"features.{i}.weight" for i in convs}
    want |= {f"features.{i}.{k}" for i in bns
             for k in ("weight", "bias", "running_mean", "running_var",
                       "num_batches_tracked")}
    assert set(sd) == want
    assert sd["classifier.0.weight"].shape == (100, 512 * 1 * 1)
    assert sd["features.26.weight"].shape == (512, 512, 3, 3)


def test_discriminator_matches_jax_in_train_and_eval_mode(jax_disc):
    disc_j, variables, x = jax_disc
    disc = _port_disc(variables).train()
    want, mut = disc_j.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = disc(torch.from_numpy(x))
    assert got.shape == (3, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_DISC)
    # the running statistics after one train-mode forward (torch's
    # momentum 0.1 and unbiased running variance on both sides)
    stats = from_jax_variables({"params": variables["params"],
                                "batch_stats": _np_tree(mut["batch_stats"])})
    sd = disc.state_dict()
    for key, value in stats.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[key].numpy(), value.numpy(),
                                       rtol=0, atol=ATOL_STATS, err_msg=key)
    disc.eval()
    want_eval = disc_j.apply({"params": variables["params"],
                              "batch_stats": _np_tree(mut["batch_stats"])},
                             jnp.asarray(x), train=False)
    with torch.no_grad():
        got_eval = disc(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               rtol=0, atol=ATOL_DISC)


def test_fc1_permutation_inverts_the_reference_conversion():
    """A reference-layout state_dict taken to the JAX layout by the JAX
    package's converter (CHW -> HWC on fc1) and back by the port's comes
    back exactly: the port keeps the reference's CHW layout."""
    ref = ESRGANDiscriminator(
        image_size=64, generator=torch.Generator().manual_seed(4))
    sd = ref.state_dict()
    back = from_jax_variables(convert_esrgan_discriminator(sd, 64))
    assert set(back) == set(sd)
    for key, value in sd.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)


def test_discriminator_bf16_keeps_f32_statistics(jax_disc):
    _, variables, x = jax_disc
    disc = _port_disc(variables, compute_dtype=torch.bfloat16).train()
    with torch.no_grad():
        out = disc(torch.from_numpy(x))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    for name, buf in disc.named_buffers():
        if "running" in name:
            assert buf.dtype == torch.float32, name
    ref = _port_disc(variables).train()
    with torch.no_grad():
        want = ref(torch.from_numpy(x))
    # bf16 convs and dense layers: the logits of this near-init
    # discriminator are small sums of many bf16-rounded terms (measured
    # 5.4% of the largest); this bounds gross errors of the policy only
    assert float((out - want).abs().max()) <= 0.1 * float(want.abs().max())


@pytest.mark.parametrize("max_convs", [2, 3, 4, None])
def test_vgg_matches_jax(max_convs):
    # None: the whole trunk (16 convs, four max-pools, relu5_4) on a
    # 32 x 32 image, so that its last map is 2 x 2 and the pools'
    # positions matter; held at 1e-5 of the output's largest value
    full = max_convs is None
    seed = 16 if full else max_convs
    vgg_j = JaxVGG(max_convs=max_convs)
    x = np.random.default_rng(seed).random(
        (1, 32, 32, 3) if full else (2, 16, 16, 3)).astype(np.float32)
    variables = _np_tree(dict(vgg_j.init(jax.random.PRNGKey(seed),
                                         jnp.asarray(x))))
    want = np.asarray(vgg_j.apply(variables, jnp.asarray(x)))
    vgg = VGG19Features(max_convs)
    sd = from_jax_variables(variables)
    assert set(sd) == set(vgg.state_dict())
    vgg.load_state_dict(sd)
    with torch.no_grad():
        got = vgg(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if full:
        assert got.shape == (1, 2, 2, 512) and np.abs(want).max() > 0
    atol = 1e-5 * float(np.abs(want).max()) if full else ATOL_VGG
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _torchvision_sequential():
    """A torchvision-layout VGG19 ``features[:36]`` (the hub file's keys)."""
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512]
    torch.manual_seed(0)
    layers, in_ch = [], 3
    for item in cfg:
        if item == "M":
            layers.append(torch.nn.MaxPool2d(2, 2))
            continue
        conv = torch.nn.Conv2d(in_ch, item, 3, padding=1)
        with torch.no_grad():
            conv.weight.mul_(0.1)  # keep activations in range
        layers += [conv, torch.nn.ReLU()]
        in_ch = item
    return torch.nn.Sequential(*layers)


def test_vgg_loads_a_torchvision_state_dict(tmp_path):
    from torchsr_tpu_torch.train.trainer import _load_vgg_weights

    seq = _torchvision_sequential().eval()
    sd = {f"features.{k}": v for k, v in seq.state_dict().items()}
    # a full torchvision vgg19 file also holds the classifier
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    path = tmp_path / "vgg19-dcbb9e9d.pth"
    torch.save(sd, path)
    x = np.random.default_rng(0).random((1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = seq(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    vgg = VGG19Features()
    load_vgg19_state_dict(vgg, _load_vgg_weights(str(path)))
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-4,
                               atol=1e-5)
    # a truncated trunk takes its convs from the full file; bare keys too
    short = VGG19Features(4)
    load_vgg19_state_dict(short, seq.state_dict())
    torch.testing.assert_close(short.features[5].weight, seq[5].weight)
    with pytest.raises(ValueError, match="lack"):
        load_vgg19_state_dict(VGG19Features(), {"0.weight": seq[0].weight})

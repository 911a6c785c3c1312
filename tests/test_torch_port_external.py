"""Public RRDBNet checkpoints and stacked (``--fast-compile``) trees.

The port's ``canonical_esrgan_sd`` and ``externalize_esrgan_sd`` are
held against the JAX package's ``_canonical_esrgan_sd`` and
``externalize_esrgan_sd``, and both against renames built here
independently from each scheme's published key layout (the method of
tests/test_external_import.py), so a mapping fault on either side
fails.  ``test`` on a checkpoint in each scheme must write the bytes it
writes on the reference-named one; the refusals raise in both packages;
the export tool round-trips.  A stacked tree made by the JAX package's
``stack_blocks`` loads equal to the unrolled one.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.models import ESRGANGenerator as JaxESRGAN
from torchsr_tpu.models import torch_compat as jax_compat
from torchsr_tpu.models.scan_compat import stack_blocks as jax_stack
from torchsr_tpu.utils.checkpoint import save_checkpoint as jax_save
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.models import scan_compat
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.models.torch_compat import (
    canonical_esrgan_sd,
    externalize_esrgan_sd,
    from_jax_variables,
)
from torchsr_tpu_torch.tools import export_torch_checkpoint
from torchsr_tpu_torch.utils.checkpoint import load_checkpoint

N_BLOCKS = 2


# for the module, its module fixtures included
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_old_arch(key: str) -> str:
    key = re.sub(r"^blocks\.(\d+)\.(RDB\d)\.(conv[1-4])\.0\.",
                 r"model.1.sub.\1.\2.\3.0.", key)
    key = re.sub(r"^blocks\.(\d+)\.(RDB\d)\.conv5\.",
                 r"model.1.sub.\1.\2.conv5.0.", key)
    for ref, ext in (("conv1.", "model.0."),
                     ("conv2.", f"model.1.sub.{N_BLOCKS}."),
                     ("upsample1.", "model.3."), ("upsample2.", "model.6."),
                     ("conv3.0.", "model.8."), ("conv4.", "model.10.")):
        if key.startswith(ref):
            return ext + key[len(ref):]
    return key


def _to_new_arch(key: str) -> str:
    key = re.sub(r"^blocks\.(\d+)\.(RDB\d)\.(conv\d)(?:\.0)?\.",
                 r"RRDB_trunk.\1.\2.\3.", key)
    for ref, ext in (("conv1.", "conv_first."), ("conv2.", "trunk_conv."),
                     ("upsample1.", "upconv1."), ("upsample2.", "upconv2."),
                     ("conv3.0.", "HRconv."), ("conv4.", "conv_last.")):
        if key.startswith(ref):
            return ext + key[len(ref):]
    return key


def _to_basicsr(key: str) -> str:
    key = re.sub(r"^blocks\.(\d+)\.RDB(\d)\.(conv\d)(?:\.0)?\.",
                 r"body.\1.rdb\2.\3.", key)
    for ref, ext in (("conv1.", "conv_first."), ("conv2.", "conv_body."),
                     ("upsample1.", "conv_up1."), ("upsample2.", "conv_up2."),
                     ("conv3.0.", "conv_hr."), ("conv4.", "conv_last.")):
        if key.startswith(ref):
            return ext + key[len(ref):]
    return key


SCHEMES = {"old_arch": _to_old_arch, "rrdbnet": _to_new_arch,
           "basicsr": _to_basicsr}


@pytest.fixture(scope="module")
def reference_sd():
    gen = ESRGANGenerator(num_rrdb_blocks=N_BLOCKS,
                          generator=torch.Generator().manual_seed(3))
    return {k: v.detach().clone() for k, v in gen.state_dict().items()}


def _external(sd, scheme):
    return {SCHEMES[scheme](k): v for k, v in sd.items()}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_canonical_equals_jax_and_the_reference(reference_sd, scheme):
    ext = _external(reference_sd, scheme)
    assert set(ext).isdisjoint(reference_sd)
    ours = canonical_esrgan_sd(ext)
    theirs = jax_compat._canonical_esrgan_sd(ext)
    assert ours.keys() == theirs.keys() == reference_sd.keys()
    for k, v in reference_sd.items():
        assert ours[k] is ext[SCHEMES[scheme](k)] is theirs[k]
    assert canonical_esrgan_sd(reference_sd) == reference_sd


@pytest.mark.parametrize("scheme", ["reference", "rrdbnet", "basicsr"])
def test_externalize_equals_jax_and_the_renames(reference_sd, scheme):
    ours = externalize_esrgan_sd(reference_sd, scheme)
    assert ours == jax_compat.externalize_esrgan_sd(reference_sd, scheme)
    if scheme != "reference":
        assert ours == _external(reference_sd, scheme)
    assert canonical_esrgan_sd(ours) == reference_sd


def _save_in_scheme(sd, scheme, path):
    """The file as each toolchain ships it: the reference's wrapped
    dict, xinntao's bare state_dicts, BasicSR's ``params_ema`` (with a
    ``params`` beside it, which the EMA weights take precedence over)."""
    if scheme == "reference":
        payload = {"epoch": 1, "phase": "esrgan-gan", "state": sd}
    elif scheme == "basicsr":
        ext = _external(sd, scheme)
        payload = {"params_ema": ext,
                   "params": {k: torch.zeros_like(v) for k, v in ext.items()}}
    else:
        payload = _external(sd, scheme)
    torch.save(payload, path)


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("photo")
    rng = np.random.default_rng(11)
    Image.fromarray(rng.integers(0, 256, (12, 16, 3), np.uint8)).save(
        root / "photo.png")
    return str(root / "photo.png")


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_test_on_a_public_checkpoint_writes_the_reference_bytes(
        reference_sd, scheme, photo, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = {}
    for name in ("reference", scheme):
        _save_in_scheme(reference_sd, name, f"{name}.pth")
        cli.main(["test", photo, "--checkpoint", f"{name}.pth",
                  "--device", "cpu"])
        out[name] = open("upres-photo.png", "rb").read()
    assert out["reference"] == out[scheme]
    got = load_checkpoint(f"{scheme}.pth", "esrgan")["state"]
    assert all(torch.equal(got[k], v) for k, v in reference_sd.items())


def test_refusals_match_jax(reference_sd):
    cases = {
        "recognize": {**_external(reference_sd, "rrdbnet"),
                      "mystery.weight": torch.zeros(1)},
        "model.10": {k: v for k, v in _external(reference_sd,
                                                "old_arch").items()
                     if not k.startswith("model.10.")},
        "pixel-unshuffled": {
            **_external(reference_sd, "basicsr"),
            "conv_first.weight": torch.zeros(64, 12, 3, 3)},
    }
    for match, sd in cases.items():
        with pytest.raises(ValueError, match=match):
            canonical_esrgan_sd(sd)
        with pytest.raises(ValueError, match=match):
            jax_compat._canonical_esrgan_sd(sd)
    with pytest.raises(ValueError, match="cannot externalize"):
        externalize_esrgan_sd({**reference_sd, "upsample3.weight": 0},
                              "basicsr")
    with pytest.raises(ValueError, match="unknown scheme"):
        externalize_esrgan_sd(reference_sd, "onnx")


@functools.cache
def _jax_tree(n_blocks):
    """The JAX generator's parameter layout, traced (nothing runs)."""
    gen = JaxESRGAN(num_rrdb_blocks=n_blocks, fused_rdb=False)
    return jax.eval_shape(lambda k: gen.init(k, jnp.zeros((1, 8, 8, 3)),
                                             train=False),
                          jax.random.PRNGKey(4))["params"]


def _jax_variables(n_blocks=N_BLOCKS):
    """JAX generator variables of that layout, filled with seeded values
    (only key maps and copies read them)."""
    rng = np.random.default_rng(n_blocks)
    return {"params": jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        _jax_tree(n_blocks))}


@pytest.mark.parametrize("scheme", ["reference", "rrdbnet", "basicsr"])
@pytest.mark.parametrize("source", ["pth", "ckpt"])
def test_export_tool_round_trips(reference_sd, tmp_path, scheme, source):
    if source == "pth":
        src = str(tmp_path / "esrgan-gan-best.pth")
        _save_in_scheme(reference_sd, "reference", src)
        want = reference_sd
    else:
        src = str(tmp_path / "esrgan-gan-best.ckpt")
        variables = _jax_variables()
        jax_save(src, 2, "esrgan-gan", variables)
        want = from_jax_variables(variables)
    out = export_torch_checkpoint.main([src, "--scheme", scheme])
    assert out == str(tmp_path / f"esrgan-gan-best-{scheme}.pth")
    raw = torch.load(out, weights_only=True)
    if scheme == "basicsr":
        assert set(raw) == {"params"}
    elif scheme == "reference":
        assert raw["epoch"] == (1 if source == "pth" else 2)
    got = load_checkpoint(out, "esrgan")["state"]
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_stacked_tree_loads_equal_to_the_unrolled():
    variables = _jax_variables(3)
    stacked = {"params": jax.tree.map(np.asarray,
                                      jax_stack(variables["params"]))}
    assert "blocks_scan" in stacked["params"]
    want = from_jax_variables(variables)
    got = from_jax_variables(stacked)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())


@pytest.mark.parametrize("leaf", ["numpy", "torch"])
def test_stack_and_unroll_round_trip(leaf):
    params = _jax_variables(3)["params"]
    if leaf == "torch":
        params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    stacked = scan_compat.stack_blocks(params)
    assert scan_compat.is_scan_layout(stacked)
    assert not any(k.startswith("block") and k[5:].isdigit()
                   for k in stacked)
    kernel = stacked["blocks_scan"]["block"]["rdb1"]["conv1"]["conv"][
        "kernel"]
    assert kernel.shape[0] == 3
    if leaf == "numpy":
        want = jax.tree.map(np.asarray, jax_stack(params))
        np.testing.assert_array_equal(
            kernel, want["blocks_scan"]["block"]["rdb1"]["conv1"]["conv"][
                "kernel"])
    back = scan_compat.unroll_blocks(stacked)
    assert back.keys() == params.keys()
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert scan_compat.unroll_blocks(params).keys() == params.keys()
    assert scan_compat.stack_blocks({"conv1": 1}) == {"conv1": 1}


def test_train_starts_from_a_public_checkpoint(reference_sd, image_dir,
                                               tmp_path, monkeypatch,
                                               capsys):
    """``train --psnr-checkpoint`` on a BasicSR release: its weights,
    under the reference's names, are the pretrain's starting point."""
    from torchsr_tpu_torch.train import trainer as trainer_mod

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    _save_in_scheme(reference_sd, "basicsr", "RealESRGAN.pth")
    seen = {}
    real = trainer_mod.GANTrainer._restore

    def restore(self, checkpoint, phase):
        out = real(self, checkpoint, phase)
        seen.setdefault(phase, {k: v.clone()
                                for k, v in self.gen.state_dict().items()})
        return out

    monkeypatch.setattr(trainer_mod.GANTrainer, "_restore", restore)
    cli.main(["train", "--device", "cpu", "--train-dir", image_dir,
              "--gen-blocks", str(N_BLOCKS), "--vgg-convs", "2",
              "--crop-size", "32", "--batch-size", "4", "--epochs", "0",
              "--pretrain-epochs", "1", "--skip-image-save", "--sync-saves",
              "--psnr-checkpoint", "RealESRGAN.pth"])
    assert "Resuming pre-training from epoch 1" in capsys.readouterr().out
    assert all(torch.equal(seen["psnr"][k], v)
               for k, v in reference_sd.items())

"""One training step of the tiny flagship: the PyTorch port against the JAX
package's `make_train_step`, from the same weights on the same batch.

The port's seeded weights go into JAX through
`enhanced_unet_tpu.convert.torch_import.convert_enhanced_unet`, and every
dropout and stochastic-depth rate is 0 on both sides (their random streams
cannot match across frameworks).  fp32 on the CPU, efficientnet-tiny
encoders, a 2 x 64^2 batch of blob images with a padded strip outside
`valid`.  Bounds:

- the loss to rtol 2e-4;
- the gradient tree (mapped through the same converter) to relative L2
  8e-2 under the full loss, whose focal and Dice terms at random weights
  amplify fp32 summation noise in the backward (the calibration of
  tests/test_train_oracle_flagship.py), and 1e-4 under a smooth L2 loss on
  the logits.  The smooth check runs both sides in float64 (the logits still
  round to fp32 at the model's output): in fp32, train-mode BatchNorm over
  the 2 x 2 maps and the pooled ASPP branch of a 2 x 64^2 batch leaves each
  framework about 9e-3 from its own float64 gradient (the port: 8.8e-3),
  which would hide a systematic error; in float64 the two agree to 6e-7;
- every BatchNorm running statistic after the step to 1e-4 of its max
  |value|;
- the step itself: AdamW's first update is about lr * sign(g), so the
  updates agree in sign on at least 98% of the elements (a gradient near 0
  can flip one) and in RMS to 1e-3.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from enhanced_unet_tpu import config as jconfig
from enhanced_unet_tpu.convert.torch_import import convert_enhanced_unet
from enhanced_unet_tpu.models.enhanced_unet import EnhancedUNet as JEnhancedUNet
from enhanced_unet_tpu.ops.losses import combined_loss_with_aux as j_loss
from enhanced_unet_tpu.train import trainer as jtrainer
from enhanced_unet_tpu_torch import config
from enhanced_unet_tpu_torch.models import get_model
from enhanced_unet_tpu_torch.ops.losses import combined_loss_with_aux
from enhanced_unet_tpu_torch.train.trainer import create_train_state, make_train_step

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")
OFF = dict(fusion_dropout=(0.0, 0.0), drop_connect_rate=0.0, aspp_dropout=0.0)
STEPS_PER_EPOCH = 4


def _make_data(n=2, size=64, seed=0):
    """Blob images with live and dead disks, a strip of padding."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, size, size, 3), np.float32)
    masks = np.zeros((n, size, size), np.int64)
    yy, xx = np.mgrid[:size, :size]
    for i in range(n):
        img = 0.65 + 0.05 * np.sin(yy / 9.0) + rng.normal(0, 0.02, (size, size))
        img = np.stack([img] * 3, -1)
        for _ in range(5):
            cy, cx = rng.integers(8, size - 8, 2)
            r, cls = rng.integers(4, 9), int(rng.integers(1, 3))
            disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            img[disk] = 0.5 if cls == 1 else 0.35
            masks[i][disk] = cls
        images[i] = np.clip(img, 0, 1)
    valid = np.ones((n, size, size), bool)
    valid[:, size - 8:, :] = False
    return images, masks, valid


def _grad_tree(model, sd):
    """The model's `.grad`s under the JAX tree layout (the never-called
    head attention gets zeros, which the converter drops)."""
    grad_sd = dict(sd)
    for k, p in model.named_parameters():
        grad_sd[k] = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
    return convert_enhanced_unet(grad_sd, TINY)[0]


def _tree_rel_l2(ours, ref):
    flat = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    num = den = 0.0
    for path, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
        r = np.asarray(r, np.float64)
        num += float(np.sum((np.asarray(flat[path], np.float64) - r) ** 2))
        den += float(np.sum(r ** 2))
    return (num / max(den, 1e-30)) ** 0.5


@pytest.fixture(scope="module")
def step_pair():
    images, masks, valid = _make_data()
    cfg = config.get_preset("enhanced_unet")
    port = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=3,
                     encoder_names=TINY, **OFF)
    sd0 = {k: v.clone() for k, v in port.state_dict().items()}
    params, stats = convert_enhanced_unet(sd0, TINY)
    x, m, v = map(torch.from_numpy, (images, masks, valid))

    # the port: the gradients of both losses on copies (the smooth one in
    # float64), then the step
    probe = copy.deepcopy(port).train()
    combined_loss_with_aux(*probe(x), m, cfg.loss, v).backward()
    grads = {"full": _grad_tree(probe, sd0)}
    probe = get_model("enhanced_unet", dtype=torch.float64, device="cpu",
                      encoder_names=TINY, **OFF).double()
    probe.load_state_dict(sd0)
    (probe.train()(x.double())[0].double() ** 2).sum().backward()
    grads["smooth"] = _grad_tree(probe, sd0)
    state = create_train_state(port, cfg, STEPS_PER_EPOCH, device="cpu")
    state, out = make_train_step(cfg)(state, x, m, v, torch.Generator().manual_seed(0))
    new_params, new_stats = convert_enhanced_unet(port.state_dict(), TINY)
    ours = dict(loss=out["loss"].item(), grads=grads, params=new_params,
                stats=new_stats, step=state.step)

    # JAX: its train step, and the gradients of both losses at the same point
    jcfg = jconfig.get_preset("enhanced_unet")
    model = JEnhancedUNet(encoder_names=TINY, dtype=jnp.float32, **OFF)
    tx = jtrainer.make_optimizer(jcfg, STEPS_PER_EPOCH)
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=stats, opt_state=tx.init(params),
                                 apply_fn=model.apply, tx=tx)
    train_step = jtrainer.make_train_step(jcfg)
    xj, mj, vj = jnp.asarray(images), jnp.asarray(masks, jnp.int32), jnp.asarray(valid)

    def forward(module, p, s, x):
        (logits, aux), _ = module.apply({"params": p, "batch_stats": s}, x,
                                        train=True, mutable=["batch_stats"])
        return logits, aux

    def run(jstate):
        new, metrics = train_step(jstate, xj, mj, vj, jax.random.key(0))
        full = jax.grad(lambda p: j_loss(*forward(model, p, stats, xj), mj,
                                         jcfg.loss, vj))(jstate.params)
        return new, metrics["loss"], full

    new, loss, full = jax.jit(run)(jstate)
    with jax.enable_x64(True):
        model64 = JEnhancedUNet(encoder_names=TINY, dtype=jnp.float64, **OFF)
        p64, s64 = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                    for t in (params, stats))
        smooth = jax.jit(jax.grad(lambda p: jnp.sum(forward(
            model64, p, s64, jnp.asarray(images, jnp.float64))[0].astype(jnp.float64) ** 2)))(p64)
    ref = dict(loss=float(loss), grads={"full": full, "smooth": smooth},
               params=new.params, stats=new.batch_stats)
    return ours, ref, params


def test_one_step_loss_matches_jax(step_pair):
    ours, ref, _ = step_pair
    assert ours["step"] == 1
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=2e-4)


@pytest.mark.parametrize("loss,bound", [("full", 8e-2), ("smooth", 1e-4)])
def test_one_step_gradients_match_jax(step_pair, loss, bound):
    ours, ref, _ = step_pair
    rel = _tree_rel_l2(ours["grads"][loss], ref["grads"][loss])
    assert rel < bound, f"gradient trees disagree: rel L2 {rel:.2e}"


def test_one_step_running_statistics_match_jax(step_pair):
    ours, ref, _ = step_pair
    flat = dict(jax.tree_util.tree_flatten_with_path(ours["stats"])[0])
    leaves = jax.tree_util.tree_flatten_with_path(ref["stats"])[0]
    assert len(leaves) == len(flat)
    for path, want in leaves:
        want = np.asarray(want, np.float64)
        diff = np.abs(np.asarray(flat[path], np.float64) - want).max()
        assert diff <= 1e-4 * np.abs(want).max() + 1e-7, jax.tree_util.keystr(path)


def test_one_step_updates_match_jax(step_pair):
    ours, ref, before = step_pair

    def update(after):
        return np.concatenate([
            (np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
            for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(before))])

    got, want = update(ours["params"]), update(ref["params"])
    assert np.mean(np.sign(got) == np.sign(want)) >= 0.98
    rms = lambda u: np.sqrt(np.mean(u ** 2))  # noqa: E731
    np.testing.assert_allclose(rms(got), rms(want), rtol=1e-3)

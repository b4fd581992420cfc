"""The PyTorch port's training pieces against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function and the port's:
the losses (value to rtol 1e-5, the gradient with respect to the logits to
1e-5 of its max |value|), the LR table (equal element for element), the
train-mode BatchNorm (outputs and running statistics to 1e-5 of max |value|),
one MBConvBlock in train mode (relative L2 of the output and of every
parameter's gradient under a smooth L2 loss below 1e-4), the optimizer
against `optax.chain(clip_by_global_norm, adamw)` (ten steps, params to rtol
1e-6 in float32 and 1e-5 with a bfloat16 first moment), the eval step's
confusion matrices (exact) and the optimizer-state carry-over (exact).  Also
the repaired fault: a train-mode forward gives every called parameter a
gradient, and an eval-mode forward that autograd would record raises before
any weight is folded or packed.  fp32, efficientnet-tiny, 64^2 or smaller.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from enhanced_unet_tpu import config as jconfig
from enhanced_unet_tpu.convert.torch_import import convert_enhanced_unet
from enhanced_unet_tpu.metrics import semantic as jsemantic
from enhanced_unet_tpu.models import blocks as jblocks
from enhanced_unet_tpu.models.encoders import MBConvBlock as JMBConvBlock
from enhanced_unet_tpu.ops import losses as jlosses
from enhanced_unet_tpu.train import schedule as jschedule
from enhanced_unet_tpu_torch import config
from enhanced_unet_tpu_torch.convert import resume_from_jax
from enhanced_unet_tpu_torch.metrics import semantic
from enhanced_unet_tpu_torch.models import blocks, get_model, init_random_weights_
from enhanced_unet_tpu_torch.models.encoders import MBConvBlock, drop_path
from enhanced_unet_tpu_torch.ops import losses
from enhanced_unet_tpu_torch.train import schedule
from enhanced_unet_tpu_torch.train.trainer import (
    AdamW,
    create_train_state,
    make_eval_step,
    make_train_step,
)

torch.set_num_threads(1)
TINY = ("efficientnet-tiny", "efficientnet-tiny")
# the UNet++ head block's attention1 exists (reference state dict) but is
# never called
UNCALLED = "unetpp.decoder.blocks.x_0_4.attention1."


def _rel_close(ours, ref, rel):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    diff = np.abs(ours - ref).max()
    assert diff <= rel * np.abs(ref).max() + 1e-7, (diff, np.abs(ref).max())


def _rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30))


def _tiny_batch(rng, size=64):
    x = rng.random((2, size, size, 3)).astype(np.float32)
    masks = rng.integers(0, 3, (2, size, size))
    valid = np.ones((2, size, size), bool)
    valid[:, :, size - size // 4:] = False
    return x, masks, valid


# ---------------------------------------------------------------- the fault

def test_train_mode_gives_every_called_parameter_a_gradient(rng):
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=1,
                      encoder_names=TINY).train()
    x, masks, valid = _tiny_batch(rng)
    logits, aux = model(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    loss = losses.combined_loss_with_aux(
        logits, aux, torch.from_numpy(masks), config.get_preset("enhanced_unet").loss,
        torch.from_numpy(valid))
    loss.backward()
    for name, p in model.named_parameters():
        if name.startswith(UNCALLED):
            assert p.grad is None, name
        else:
            assert p.grad is not None, name
            assert torch.isfinite(p.grad).all(), name
    for name in ("unetpp.encoder._blocks.0._depthwise_conv.weight",
                 "fusion_head.0.weight", "fusion_head.8.weight"):
        assert model.get_parameter(name).grad.abs().max() > 0, name


def _fused_cases():
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=1,
                      encoder_names=TINY)
    conv = blocks.ConvBNAct(8, 16, dtype=torch.float32).eval()
    block = MBConvBlock(8, 8, 1, 1, 3, fused=True, dtype=torch.float32).eval()
    return {
        "flagship": (model, lambda: model(torch.zeros(1, 64, 64, 3)),
                     [model.unetpp.encoder._blocks[0], model.fusion_head[0]]),
        "conv_bn_act": (conv, lambda: conv(torch.zeros(1, 8, 16, 16)), [conv[0]]),
        "mbconv": (block, lambda: block(torch.zeros(1, 8, 16, 16)), [block]),
    }


@pytest.mark.parametrize("case", ["flagship", "conv_bn_act", "mbconv"])
def test_eval_forward_with_grad_raises_before_folding(case):
    module, forward, holders = _fused_cases()[case]
    with pytest.raises(RuntimeError, match=r"no_grad\(\)/torch.inference_mode\(\)"):
        forward()
    for h in holders:
        assert "_folded" not in h.__dict__ and "_packed_conv3x3" not in h.__dict__
    with torch.no_grad():
        forward()
    with torch.inference_mode():
        forward()
    for p in module.parameters():
        p.requires_grad_(False)
    forward()


def test_train_mode_needs_a_generator_when_a_rate_is_set():
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu",
                      encoder_names=TINY).train()
    x = torch.rand(2, 32, 32, 3)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    off = get_model("enhanced_unet", dtype=torch.float32, device="cpu",
                    encoder_names=TINY, fusion_dropout=(0.0, 0.0),
                    drop_connect_rate=0.0, aspp_dropout=0.0).train()
    off(x)


# ------------------------------------------------------------------ losses

LOSS_CFG = config.get_preset("enhanced_unet").loss
J_LOSS_CFG = jconfig.get_preset("enhanced_unet").loss


def _loss_inputs(seed):
    r = np.random.default_rng(seed)
    shape = (2, 16, 16, 3)
    logits = {k: (r.normal(size=shape) * 2).astype(np.float32)
              for k in ("main", "unetpp", "deeplab")}
    targets = r.integers(0, 3, shape[:3])
    valid = np.ones(shape[:3], bool)
    valid[:, 11:, :] = False
    return logits, targets, valid


def _loss_pair(name, aux_keys):
    c = LOSS_CFG
    port = {
        "focal": lambda lg, t, v: losses.focal_loss(
            lg["main"], t, c.focal_alpha, c.focal_gamma, c.ce_class_weights, v),
        "dice": lambda lg, t, v: losses.dice_loss(
            lg["main"], t, c.dice_class_weights, c.eps, v),
        "tversky": lambda lg, t, v: losses.tversky_loss(
            lg["main"], t, c.tversky_class_weights, c.tversky_alpha, c.eps, v),
        "combined": lambda lg, t, v: losses.combined_loss(lg["main"], t, c, v),
        "with_aux": lambda lg, t, v: losses.combined_loss_with_aux(
            lg["main"], {k: lg[k] for k in aux_keys}, t, c, v),
    }[name]
    j = J_LOSS_CFG
    ref = {
        "focal": lambda lg, t, v: jlosses.focal_loss(
            lg["main"], t, j.focal_alpha, j.focal_gamma, j.ce_class_weights, v),
        "dice": lambda lg, t, v: jlosses.dice_loss(
            lg["main"], t, j.dice_class_weights, j.eps, v),
        "tversky": lambda lg, t, v: jlosses.tversky_loss(
            lg["main"], t, j.tversky_class_weights, j.tversky_alpha, j.eps, v),
        "combined": lambda lg, t, v: jlosses.combined_loss(lg["main"], t, j, v),
        "with_aux": lambda lg, t, v: jlosses.combined_loss_with_aux(
            lg["main"], {k: lg[k] for k in aux_keys}, t, j, v),
    }[name]
    return port, ref


_LOSS_CASES = ([(n, ()) for n in ("focal", "dice", "tversky", "combined")]
               + [("with_aux", ()), ("with_aux", ("unetpp", "deeplab")),
                  ("with_aux", ("deeplab",))])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,aux_keys", _LOSS_CASES)
def test_loss_value_and_gradient_match_jax(name, aux_keys, masked):
    logits, targets, valid = _loss_inputs(len(name) + len(aux_keys) + masked)
    port, ref = _loss_pair(name, aux_keys)
    t_logits = {k: torch.from_numpy(v).requires_grad_() for k, v in logits.items()}
    t_valid = torch.from_numpy(valid) if masked else None
    value = port(t_logits, torch.from_numpy(targets), t_valid)
    value.backward()
    j_valid = jnp.asarray(valid) if masked else None
    j_value, j_grads = jax.value_and_grad(
        lambda lg: ref(lg, jnp.asarray(targets), j_valid))(
        {k: jnp.asarray(v) for k, v in logits.items()})
    np.testing.assert_allclose(value.item(), float(j_value), rtol=1e-5)
    for k in ("main",) + aux_keys:
        _rel_close(t_logits[k].grad.numpy(), j_grads[k], 1e-5)
    if masked:   # the consistency term and the losses read no padded logit
        assert value.item() != pytest.approx(port(
            {k: torch.from_numpy(v) for k, v in logits.items()},
            torch.from_numpy(targets), None).item(), rel=1e-6)


# ---------------------------------------------------------------- LR table

@pytest.mark.parametrize("name", jconfig.MODEL_NAMES)
def test_lr_table_matches_jax(name):
    for epochs in (7, 50):
        cfg = config.get_preset(name, num_epochs=epochs)
        args = dict(base_lr=cfg.optimizer.base_lr, total_epochs=cfg.num_epochs,
                    warmup_epochs=cfg.warmup_epochs, t0=cfg.cosine_t0,
                    t_mult=cfg.optimizer.t_mult, eta_min=cfg.optimizer.eta_min,
                    start_factor=cfg.optimizer.warmup_start_factor)
        ours = schedule.reference_lr_schedule(**args)
        ref = jschedule.reference_lr_schedule(**args)
        assert ours.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(ours, ref)


def test_lr_fn_matches_jax_at_the_epoch_boundaries():
    table = jschedule.reference_lr_schedule(4e-3, 12, 2, 10)
    ours, ref = schedule.make_lr_fn(table, 5), jschedule.make_lr_fn(table, 5)
    for count in (0, 1, 4, 5, 6, 9, 10, 54, 55, 59, 60, 61, 1000):
        want = np.asarray(ref(jnp.asarray(count, jnp.int32)))
        assert want.dtype == np.float32 and ours(count) == float(want), count


# ------------------------------------------------------- train-mode blocks

def _conv_tree(layer):
    w = layer.weight.detach().numpy()
    tree = {"kernel": jnp.array(np.transpose(w, (2, 3, 1, 0)))}
    if layer.bias is not None:
        tree["bias"] = jnp.array(layer.bias.detach().numpy())
    return tree


def _bn_trees(bn):
    t = lambda v: jnp.array(v.detach().numpy())  # noqa: E731  (a copy: BN edits in place)
    return ({"scale": t(bn.weight), "bias": t(bn.bias)},
            {"mean": t(bn.running_mean), "var": t(bn.running_var)})


def _train_bn_case(kind, rng):
    """(port module, its BN, input NCHW numpy, flax reference callable)."""
    f32 = torch.float32
    if kind == "conv_bn_act":
        port = blocks.ConvBNAct(6, 12, dtype=f32)
        bn, conv_layers = port[1], {"Conv_0": port[0]}
        x = rng.normal(size=(2, 6, 12, 12))
        ref = jblocks.ConvBNAct(12, dtype=jnp.float32)
    elif kind == "separable":
        port = blocks.SeparableConvBNAct(6, 12, dilation=2, dtype=f32)
        bn, conv_layers = port[1], {"Conv_0": port[0][0], "Conv_1": port[0][1]}
        x = rng.normal(size=(2, 6, 12, 12))
        ref = jblocks.SeparableConvBNAct(12, dilation=2, dtype=jnp.float32)
    else:
        port = blocks.ASPPPooling(6, 12, dtype=f32)
        bn, conv_layers = port[2], {"Conv_0": port[1]}
        x = rng.normal(size=(2, 6, 8, 8))
        ref = jblocks.ConvBNAct(12, (1, 1), dtype=jnp.float32)
    init_random_weights_(port, 5)
    bn_p, bn_s = _bn_trees(bn)
    variables = {"params": {**{k: _conv_tree(v) for k, v in conv_layers.items()},
                            "BatchNorm_0": bn_p},
                 "batch_stats": {"BatchNorm_0": bn_s}}

    def run_ref(x_nhwc):
        if kind == "aspp_pooling":
            g = jnp.mean(x_nhwc, axis=(1, 2), keepdims=True)
            y, mut = ref.apply(variables, g, True, mutable=["batch_stats"])
            return jnp.broadcast_to(y, x_nhwc.shape[:3] + (12,)), mut
        return ref.apply(variables, x_nhwc, True, mutable=["batch_stats"])

    return port.train(), bn, x.astype(np.float32), run_ref


@pytest.mark.parametrize("kind", ["conv_bn_act", "separable", "aspp_pooling"])
def test_train_mode_batch_norm_matches_flax(kind, rng):
    port, bn, x, run_ref = _train_bn_case(kind, rng)
    before = bn.running_var.clone()
    y = port(torch.from_numpy(x))
    ref_y, mut = run_ref(jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    _rel_close(y.detach().permute(0, 2, 3, 1).numpy(), ref_y, 1e-5)
    stats = mut["batch_stats"]["BatchNorm_0"]
    _rel_close(bn.running_mean.numpy(), stats["mean"], 1e-5)
    _rel_close(bn.running_var.numpy(), stats["var"], 1e-5)
    assert not torch.equal(bn.running_var, before)


def _mbconv_variables(block):
    expand = block.expand_ratio != 1
    convs = (["_expand_conv"] if expand else []) + [
        "_depthwise_conv", "_se_reduce", "_se_expand", "_project_conv"]
    bns = (["_bn0"] if expand else []) + ["_bn1", "_bn2"]
    params = {f"Conv_{i}": _conv_tree(getattr(block, n)) for i, n in enumerate(convs)}
    stats = {}
    for i, n in enumerate(bns):
        params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"] = _bn_trees(getattr(block, n))
    return {"params": params, "batch_stats": stats}, convs, bns


@pytest.mark.parametrize("cin,cout,expand,stride,kernel", [
    (8, 8, 1, 1, 3),        # a fused (stage-0) block: train mode takes the stock path
    (8, 16, 6, 2, 5),
    (16, 16, 6, 1, 3),
])
def test_mbconv_block_train_mode_matches_flax(rng, cin, cout, expand, stride, kernel):
    block = MBConvBlock(cin, cout, expand, stride, kernel, fused=expand == 1,
                        dtype=torch.float32)
    init_random_weights_(block, 7).train()
    variables, convs, bns = _mbconv_variables(block)
    x = rng.normal(size=(2, cin, 16, 16)).astype(np.float32)
    y = block(torch.from_numpy(x))
    (y ** 2).sum().backward()
    ref = JMBConvBlock(cin, cout, expand, (stride, stride), kernel, drop_rate=0.0,
                       dtype=jnp.float32)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))

    def loss_fn(params):
        out, mut = ref.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             xj, True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, mut)

    grads, (ref_y, mut) = jax.grad(loss_fn, has_aux=True)(variables["params"])
    assert _rel_l2(y.detach().permute(0, 2, 3, 1).numpy(), ref_y) < 1e-4
    for i, n in enumerate(convs):
        w = getattr(block, n).weight.grad.numpy()
        assert _rel_l2(np.transpose(w, (2, 3, 1, 0)), grads[f"Conv_{i}"]["kernel"]) < 1e-4, n
    for i, n in enumerate(bns):
        bn = getattr(block, n)
        assert _rel_l2(bn.weight.grad.numpy(), grads[f"BatchNorm_{i}"]["scale"]) < 1e-4, n
        assert _rel_l2(bn.bias.grad.numpy(), grads[f"BatchNorm_{i}"]["bias"]) < 1e-4, n
        _rel_close(bn.running_var.numpy(), mut["batch_stats"][f"BatchNorm_{i}"]["var"], 1e-5)


# ------------------------------------------------- stochastic regularisers

def test_drop_path_mask_is_per_sample_seeded_and_scaled():
    y = torch.ones(4000, 2, 3, 3)
    out = drop_path(y, 0.3, torch.Generator().manual_seed(4))
    again = drop_path(y, 0.3, torch.Generator().manual_seed(4))
    assert torch.equal(out, again)
    per_sample = out.reshape(4000, -1)
    assert (per_sample == per_sample[:, :1]).all()          # one draw per sample
    values = per_sample[:, 0].unique().tolist()
    assert values == [0.0, pytest.approx(1 / 0.7)]
    keep = (per_sample[:, 0] > 0).float().mean().item()
    assert abs(keep - 0.7) < 4 * (0.21 / 4000) ** 0.5
    assert not torch.equal(out, drop_path(y, 0.3, torch.Generator().manual_seed(5)))


def test_dropout_is_element_wise_seeded_and_scaled():
    x = torch.ones(2, 8, 50, 50)
    out = blocks.dropout(x, 0.2, torch.Generator().manual_seed(1))
    assert torch.equal(out, blocks.dropout(x, 0.2, torch.Generator().manual_seed(1)))
    assert out.unique().tolist() == [0.0, pytest.approx(1 / 0.8)]
    keep = (out > 0).float().mean().item()
    assert abs(keep - 0.8) < 4 * (0.16 / out.numel()) ** 0.5
    # element-wise, not channel-wise: a channel's map is not all kept or dropped
    per_channel = (out > 0).float().mean(dim=(2, 3))
    assert ((per_channel > 0) & (per_channel < 1)).all()
    assert torch.equal(blocks.dropout(x, 0.0, None), x)


def test_stochastic_depth_rates_follow_the_block_index():
    from enhanced_unet_tpu_torch.models.encoders import EfficientNetEncoder

    enc = EfficientNetEncoder("efficientnet-b0", drop_connect_rate=0.2)
    n = len(enc._blocks)
    assert [b.drop_rate for b in enc._blocks] == pytest.approx(
        [0.2 * i / n for i in range(n)])


# --------------------------------------------------------------- optimizer

@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_optimizer_matches_optax(mu_dtype):
    r = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    params = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    table = jschedule.reference_lr_schedule(1e-2, 6, 2, 10)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        jschedule.make_lr_fn(table, 3), b1=0.9, b2=0.999, weight_decay=1e-2,
        mu_dtype=jnp.dtype(mu_dtype)))
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = tx.init(j_params)
    ours = AdamW(schedule.make_lr_fn(table, 3), 0.9, 0.999, 1e-2, 1.0,
                 mu_dtype=getattr(torch, mu_dtype))
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = ours.init(t_params)
    clipped = 0
    for _ in range(10):
        grads = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        clipped += optax.global_norm(grads) >= 1.0
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                     j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        state = ours.update(t_params, {k: torch.from_numpy(v) for k, v in grads.items()},
                            state)
    assert clipped >= 8 and state.count == 10
    rtol = 1e-6 if mu_dtype == "float32" else 1e-5
    j_adam = j_state[1][0]
    for k in shapes:
        np.testing.assert_allclose(t_params[k].numpy(), j_params[k], rtol=rtol, atol=1e-7)
        assert state.mu[k].dtype == getattr(torch, mu_dtype)
        np.testing.assert_allclose(state.mu[k].float().numpy(),
                                   np.asarray(j_adam.mu[k], np.float32), rtol=rtol, atol=1e-7)
        np.testing.assert_allclose(state.nu[k].numpy(), j_adam.nu[k], rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------- eval step

def test_eval_step_confusion_matrices_match_jax(rng):
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=2,
                      encoder_names=TINY)
    cfg = config.get_preset("enhanced_unet")
    state = create_train_state(model, cfg, steps_per_epoch=4, device="cpu")
    x, masks, valid = _tiny_batch(rng)
    logits, cms = make_eval_step(cfg)(state, torch.from_numpy(x),
                                      torch.from_numpy(masks), torch.from_numpy(valid))
    assert cms.dtype == torch.int64 and cms.shape == (2, 3, 3)
    pred = np.where(valid, np.argmax(logits.numpy(), -1), 0)
    ref = jsemantic.batched_confusion_matrix(jnp.asarray(pred),
                                             jnp.asarray(np.where(valid, masks, 0)))
    np.testing.assert_array_equal(cms.numpy(), np.asarray(ref))
    assert (cms.sum((1, 2)) == 64 * 64).all()
    # the numpy layer on top of the matrices
    r = np.random.default_rng(6)
    p, g = r.integers(0, 3, (40, 40)), r.integers(0, 3, (40, 40))
    assert semantic.calculate_semantic_metrics(p, g) == jsemantic.calculate_semantic_metrics(p, g)
    assert semantic.calculate_iou(p == 1, g == 1) == jsemantic.calculate_iou(p == 1, g == 1)
    assert semantic.calculate_dice(p == 2, g == 2) == jsemantic.calculate_dice(p == 2, g == 2)


# ------------------------------------------------------------ carry-over

def test_optimizer_state_carries_over_from_jax():
    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=4,
                      encoder_names=TINY)
    params, stats = convert_enhanced_unet(model.state_dict(), TINY)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-3, mu_dtype=jnp.bfloat16))
    clip_state, (adam, *rest) = tx.init(params)
    # a state two updates in: moments with the params' tree, mu in bf16
    adam = adam._replace(count=jnp.asarray(2, jnp.int32),
                         mu=jax.tree.map(lambda p: (p * 0.5 + 0.01).astype(jnp.bfloat16),
                                         params),
                         nu=jax.tree.map(lambda p: p * p + 1e-3, params))
    opt_state = (clip_state, (adam, *rest))
    cfg = config.get_preset("enhanced_unet", overrides={"optimizer": dataclasses.replace(
        config.OptimizerConfig(), mu_dtype="bfloat16")})
    fresh = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=9,
                      encoder_names=TINY)
    state = resume_from_jax(create_train_state(fresh, cfg, 4, device="cpu"),
                            params, stats, opt_state, TINY)
    assert state.step == state.opt_state.count == 2
    for k, v in model.state_dict().items():
        if not k.startswith(UNCALLED) and not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k
    names = {n for n, _ in fresh.named_parameters()}
    assert set(state.opt_state.mu) == set(state.opt_state.nu) == names
    for moment, tree, dtype in ((state.opt_state.mu, adam.mu, torch.bfloat16),
                                (state.opt_state.nu, adam.nu, torch.float32)):
        assert {t.dtype for t in moment.values()} == {dtype}
        back, _ = convert_enhanced_unet(
            {**model.state_dict(), **{k: v.float() for k, v in moment.items()}}, TINY)
        for (path, want), (_, got) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                          jax.tree_util.tree_flatten_with_path(back)[0]):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want, np.float32),
                                          err_msg=jax.tree_util.keystr(path))
    # and the state steps on in the port
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    state, out = make_train_step(cfg)(state, x, torch.zeros(2, 32, 32, dtype=torch.long),
                                      torch.ones(2, 32, 32, dtype=torch.bool),
                                      torch.Generator().manual_seed(1))
    assert state.step == 3 and torch.isfinite(out["loss"])


def test_compute_grad_norms_leaves_the_state_as_it_was(rng):
    from enhanced_unet_tpu_torch.train.trainer import compute_grad_norms, param_grad_norms

    model = get_model("enhanced_unet", dtype=torch.float32, device="cpu", seed=8,
                      encoder_names=TINY)
    cfg = config.get_preset("enhanced_unet")
    state = create_train_state(model, cfg, 4, device="cpu")
    x, masks, valid = (torch.from_numpy(a) for a in _tiny_batch(rng, 32))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    norms = compute_grad_norms(state, x, masks, valid, cfg)
    assert not model.training and all(p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    called = {n for n, _ in model.named_parameters() if not n.startswith(UNCALLED)}
    assert set(norms) == called and all(np.isfinite(v) and v >= 0 for v in norms.values())
    # the same draw again gives the same magnitudes
    assert compute_grad_norms(state, x, masks, valid, cfg) == norms
    g = {"a": torch.tensor([1.0, -3.0]), "b": None}
    assert param_grad_norms(g) == {"a": 2.0}

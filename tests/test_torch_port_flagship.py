"""The port's flagship family (MIL, CLAM, the ClamMLP trunk and the six
svd_gate models) against the JAX package on the CPU.

Both sides get the same weights: the JAX model is built from a seed and its
parameters go through ``survival_params_from_jax`` into the port's model;
the other way, ``import_survival_checkpoint`` loads the port's
``state_dict`` into a JAX model.  Inputs come from numpy seeds; the padded
window comes from the JAX package's ``make_window`` (bags of 3-40 WSI
patches against ``inst_number`` 8, so some bags hold fewer valid instances
than k) and is vmapped on the JAX side, while the port runs it with its
leading case axis.

Tolerances: float32 outputs, losses and gradients within rtol 1e-5, atol
1e-6 (the same float32 arithmetic summed in other orders).  bfloat16
evaluation: probabilities within 2e-2 of the JAX package's bfloat16
evaluation and within 4e-2 of float32 (the JAX package's own bar,
tests/test_trainers.py:test_bf16_eval_matches_f32); the two bfloat16 paths
round in different places (the JAX one pools bags in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.data.batching import make_window
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu.ops import masked as jmasked
from multimodal_fusion_tpu.utils.torch_import import import_survival_checkpoint
from multimodal_fusion_tpu_torch import config as tconfig
from multimodal_fusion_tpu_torch.models.factory import ModelFactory
from multimodal_fusion_tpu_torch.models.svd_gate import survival_params_from_jax
from multimodal_fusion_tpu_torch.ops import masked as tmasked
from multimodal_fusion_tpu_torch.train.survival import SurvivalTrainer

KEYS = [
    "mil", "clam", "clam_mlp", "clam_mlp_detach",
    "svd_gate_random_clam", "svd_gate_random_clam_detach",
    "clip_gate_random_clam", "clip_gate_random_clam_detach",
    "deep_supervise_svd_gate_random", "deep_supervise_svd_gate_random_detach",
]
CHANNELS = ["wsi=features", "wsi=reconstructed_features", "tma=cd3=features", "tma=cd8=features",
            "clinical=val", "clinical=mask", "blood=val", "blood=mask"]
BAG_CHANNELS = ["wsi=features", "tma=cd3=features", "tma=cd8=features"]
DIMS = {"clinical=val": 16, "blood=val": 24}
D_IN = 32
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_config(key, n_classes=2, **kw):
    chans = BAG_CHANNELS if key in ("mil", "clam") else CHANNELS
    base = dict(model_type=key, n_classes=n_classes, input_dim=D_IN, model_size="8*4",
                dropout=0.25, output_dim=16, inst_number=8, base_weight=0.7,
                channels_used_in_model=list(chans), channel_input_dims=dict(DIMS))
    base.update(kw)
    return jconfig.ModelConfig(**base)


def _port_model(jc, jmodel):
    model = ModelFactory.create_model(tconfig.ModelConfig.from_dict(jc.to_dict()), seed=1,
                                      device="cpu")
    model.load_state_dict(survival_params_from_jax(_pure(nnx.state(jmodel, nnx.Param))),
                          strict=True)
    return model


def _pure(state):
    return nnx.to_pure_dict(state)


def _raw_cases(seed, n=4, n_classes=2):
    """Ragged cases: WSI bags of 3-40 patches (and their reconstruction), 2
    TMA markers of 2-6 patches, 2 tabular groups with 0/1 masks."""
    rng = np.random.default_rng(seed)
    raws, labels = [], []
    for i in range(n):
        nw = int(rng.integers(3, 41))
        wsi = rng.standard_normal((nw, D_IN)).astype(np.float32)
        raw = {
            "wsi=features": wsi,
            "wsi=reconstructed_features": wsi + 0.1,
            "tma=cd3=features": rng.standard_normal((int(rng.integers(2, 7)), D_IN)).astype(np.float32),
            "tma=cd8=features": rng.standard_normal((int(rng.integers(2, 7)), D_IN)).astype(np.float32),
        }
        for grp, dim in (("clinical", 16), ("blood", 24)):
            raw[f"{grp}=val"] = rng.standard_normal((1, dim)).astype(np.float32)
            raw[f"{grp}=mask"] = (rng.random((1, dim)) > 0.2).astype(np.float32)
        raws.append(raw)
        labels.append(i % n_classes)
    return raws, labels


def _window(seed, n_classes=2):
    raws, labels = _raw_cases(seed, n_classes=n_classes)
    return make_window(raws, labels)


def _port_window(window, dtype=None):
    def put(v):
        t = torch.as_tensor(np.array(v))
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return ({"channels": {k: put(v) for k, v in window["channels"].items()},
             "masks": {k: put(v) for k, v in window["masks"].items()}},
            torch.as_tensor(np.array(window["label"]), dtype=torch.int64))


def _jax_eval(jmodel, window, train=False, dtype=None):
    """The JAX model vmapped over the window's cases: (per-case results,
    per-case losses).  ``dtype`` casts parameters and floating inputs as
    the JAX trainer's bfloat16 eval step does."""
    graphdef, state = nnx.split(jmodel)
    channels = window["channels"]
    if dtype is not None:
        cast = lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x  # noqa: E731
        state = jax.tree.map(cast, state)
        channels = {k: cast(jnp.asarray(v)) for k, v in channels.items()}

    def one(c, m, label):
        mm = nnx.merge(graphdef, state)
        res = mm({"channels": c, "masks": m}, label, train=train)
        return res, mm.loss_fn(res["logits"], label[None], res)

    return jax.vmap(one)(channels, window["masks"], window["label"])


def _per_case(res, key):
    """A JAX per-case entry [G, 1, ...] -> [G, ...] (scalars stay [G])."""
    a = np.asarray(res[key], np.float32)
    return a[:, 0] if a.ndim >= 2 and a.shape[1] == 1 else a


CASES = [(k, s, True, 2) for k in KEYS for s in (True, False)] + [
    ("clam", True, False, 2), ("svd_gate_random_clam", True, False, 2),
    ("mil", False, True, 3), ("clam", True, True, 3), ("svd_gate_random_clam", True, True, 3),
]


@pytest.mark.parametrize("key,subtyping,gate,n_classes", CASES)
def test_eval_forward_matches_jax(key, subtyping, gate, n_classes):
    jc = _jax_config(key, n_classes=n_classes, subtyping=subtyping, gate=gate)
    jmodel = JaxFactory.create_model(jc, seed=0)
    window = _window(3, n_classes)
    want, want_loss = _jax_eval(jmodel, window)
    model = _port_model(jc, jmodel)
    case, label = _port_window(window)
    with torch.no_grad():
        got = model(case, label)
        loss = model.loss_fn(got["logits"], label, got)
    np.testing.assert_allclose(got["logits"].numpy(), _per_case(want, "logits"), **TOL)
    np.testing.assert_allclose(got["probabilities"].numpy(), _per_case(want, "probabilities"), **TOL)
    np.testing.assert_array_equal(got["predictions"].numpy(), _per_case(want, "predictions"))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    if "aligned_features_stack" in want:
        assert got["aligned_features_stack"].shape == (4, 4, 16)  # [G, M, output_dim]
        np.testing.assert_allclose(got["aligned_features_stack"].numpy(),
                                   np.asarray(want["aligned_features_stack"]), **TOL)
    # every '*_loss' entry, per case
    for k in want:
        if k.endswith("_loss"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("key", KEYS)
def test_train_forward_and_gradients_match_jax(key):
    """train=True at dropout 0 without the random partial loss (the draws
    differ between the backends): per-case losses and every parameter's
    gradient of their mean, detached paths included."""
    jc = _jax_config(key, subtyping=True, dropout=0.0, enable_random_loss=False)
    jmodel = JaxFactory.create_model(jc, seed=2)
    window = _window(5)
    graphdef, params, rest = nnx.split(jmodel, nnx.Param, ...)

    def mean_loss(p):
        def one(c, m, label):
            mm = nnx.merge(graphdef, p, rest)
            res = mm({"channels": c, "masks": m}, label, train=True)
            return mm.loss_fn(res["logits"], label[None], res)

        losses = jax.vmap(one)(window["channels"], window["masks"], window["label"])
        return jnp.mean(losses), losses

    grads, want_loss = jax.grad(mean_loss, has_aux=True)(params)
    model = _port_model(jc, jmodel)
    case, label = _port_window(window)
    res = model(case, label, generator=torch.Generator().manual_seed(0), train=True)
    losses = model.loss_fn(res["logits"], label, res)
    losses.mean().backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_loss), **TOL)
    want_grads = survival_params_from_jax(_pure(grads))
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("key", KEYS)
def test_weights_cross_both_directions(key):
    """JAX -> port covers every port parameter; port -> JAX
    (``import_survival_checkpoint``) consumes every port key and gives the
    same parameters back."""
    jc = _jax_config(key, subtyping=True)
    jmodel = JaxFactory.create_model(jc, seed=0)
    model = _port_model(jc, jmodel)
    other = JaxFactory.create_model(jc, seed=9)
    assert import_survival_checkpoint(other, model.state_dict()) == []
    back = survival_params_from_jax(_pure(nnx.state(other, nnx.Param)))
    sd = model.state_dict()
    assert set(back) == set(sd)
    for name in sd:
        assert torch.equal(back[name], sd[name]), name


def test_imported_port_weights_give_the_same_logits():
    jc = _jax_config("svd_gate_random_clam", subtyping=True)
    port = ModelFactory.create_model(tconfig.ModelConfig.from_dict(jc.to_dict()), seed=4,
                                     device="cpu")
    jmodel = JaxFactory.create_model(jc, seed=0)
    assert import_survival_checkpoint(jmodel, port.state_dict()) == []
    window = _window(7)
    want, _ = _jax_eval(jmodel, window)
    with torch.no_grad():
        got = port(*_port_window(window))
    np.testing.assert_allclose(got["logits"].numpy(), _per_case(want, "logits"), **TOL)


def test_port_state_dict_names_follow_the_reference():
    jc = _jax_config("deep_supervise_svd_gate_random", subtyping=True, gate=True)
    jc.extra["clip_init_tau"] = 0.07
    sd = ModelFactory.create_model(tconfig.ModelConfig.from_dict(jc.to_dict()), device="cpu").state_dict()
    for name in ("attention_net.wsi=features.0.weight",
                 "attention_net.wsi=features.3.attention_a.0.weight",
                 "attention_net.tma=features.3.attention_c.bias",
                 "transfer_layer.wsi=features.weight", "transfer_layer.clinical=val.weight",
                 "classifiers.tma=features.weight", "instance_classifiers.wsi=features.0.weight",
                 "fusion_prediction.0.weight", "fusion_prediction.1.bias",
                 "TCPClassifier.blood=val.3.weight", "TCPConfidenceLayer.wsi=features.2.weight",
                 "alignment_layers.tma=features.1.weight", "Classifier.clinical=val.0.weight"):
        assert name in sd, name
    clip = ModelFactory.create_model(
        tconfig.ModelConfig.from_dict(_jax_config("clip_gate_random_clam").to_dict()),
        device="cpu").state_dict()
    assert clip["clip_logit_scale"].shape == () and float(clip["clip_logit_scale"]) == pytest.approx(
        np.log(1 / 0.07))


@pytest.mark.parametrize("largest", [True, False])
def test_masked_topk_matches_jax(largest):
    """Tied values (lower index first, as jax.lax.top_k), masked entries
    and a bag shorter than k."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (5, 24)).astype(np.float32)  # many ties
    mask = rng.random((5, 24)) > 0.3
    mask[3, 2:] = False  # 2 valid entries, k = 8
    mask[4] = False  # none valid
    for m in (None, mask):
        jv, ji = jmasked.masked_topk(jnp.asarray(scores), 8, None if m is None else jnp.asarray(m),
                                     largest=largest)
        tv, ti = tmasked.masked_topk(torch.as_tensor(scores), 8,
                                     None if m is None else torch.as_tensor(m), largest=largest)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    x = rng.standard_normal((5, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tmasked.masked_max(torch.as_tensor(x), torch.as_tensor(mask), dim=1).numpy(),
        np.asarray(jmasked.masked_max(jnp.asarray(x), jnp.asarray(mask), axis=1)))


def test_bf16_eval_matches_jax_bf16(tmp_path):
    jc = _jax_config("svd_gate_random_clam", subtyping=True)
    jc.extra["compute_dtype"] = "bfloat16"
    jmodel = JaxFactory.create_model(jc, seed=0)
    window = _window(11)
    want16, _ = _jax_eval(jmodel, window, dtype=jnp.bfloat16)
    want32, _ = _jax_eval(jmodel, window)
    tc = tconfig.Configs(model_config=tconfig.ModelConfig.from_dict(jc.to_dict()))
    tr = SurvivalTrainer(tc, tmp_path, device="cpu")
    model = _port_model(jc, jmodel)
    case, label = _port_window(window)
    logits, probs, preds, losses, risk = tr._eval_window(tr._compute_model(model),
                                                         {**case, "label": label})
    assert probs.dtype == torch.float32 and losses.dtype == torch.float32
    assert next(model.parameters()).dtype == torch.float32  # the copy is bfloat16
    p16 = np.asarray(_per_case(want16, "probabilities"), np.float32)
    np.testing.assert_allclose(probs.numpy(), p16, atol=2e-2)
    np.testing.assert_allclose(probs.numpy(), _per_case(want32, "probabilities"), atol=4e-2)
    assert np.isfinite(losses.numpy()).all() and np.isfinite(risk.numpy()).all()


def test_detach_drop_prob():
    """drop_prob 0 changes nothing; drop_prob 1 zeroes every modality, so
    the logits are the fusion head's on zeros; the draws come from the
    generator."""
    jc = _jax_config("svd_gate_random_clam_detach", subtyping=True)
    model = _port_model(jc, JaxFactory.create_model(jc, seed=0))
    case, label = _port_window(_window(2))
    with torch.no_grad():
        plain = model(case, label)["logits"]
        zero = model(case, label, generator=torch.Generator().manual_seed(0), drop_prob=0.0)["logits"]
        ones = model(case, label, generator=torch.Generator().manual_seed(0), drop_prob=1.0)["logits"]
        head = model.fusion_prediction(torch.zeros(len(label), 4 * 16))
        a = model(case, label, generator=torch.Generator().manual_seed(3), drop_prob=0.5)["logits"]
        b = model(case, label, generator=torch.Generator().manual_seed(3), drop_prob=0.5)["logits"]
    assert torch.equal(plain, zero)
    torch.testing.assert_close(ones, head, rtol=0, atol=0)
    assert torch.equal(a, b)
    assert model.supports_drop_prob
    assert not ModelFactory.create_model(
        tconfig.ModelConfig.from_dict(_jax_config("svd_gate_random_clam").to_dict()),
        device="cpu").supports_drop_prob


@pytest.mark.parametrize("key", ["svd_gate_random_clam", "clip_gate_random_clam"])
def test_group_losses_wait_for_item_8(key, tmp_path):
    """The window group loss (rank-1 SVD, "svd" impl, at the flagship
    script's tau1 = tau2 = 1 and lambda1 = 0.1; CLIP with the anchor-self
    pair) against the JAX model's ``group_loss_fn`` on the same window
    results: the value and its gradient with respect to
    ``aligned_features_stack``.  (Until the group losses were ported this
    test pinned their refusal.)"""
    jc = _jax_config(key, subtyping=True, tau1=1.0, tau2=1.0, lambda1=0.1)
    jmodel = JaxFactory.create_model(jc, seed=0)
    window = _window(3)
    want, _ = _jax_eval(jmodel, window)
    model = _port_model(jc, jmodel)
    case, label = _port_window(window)
    with torch.no_grad():
        got = model(case, label)
    stack = np.asarray(want["aligned_features_stack"])
    np.testing.assert_allclose(got["aligned_features_stack"].numpy(), stack, **TOL)
    jlabel = jnp.asarray(window["label"])
    jval, jgrad = jax.value_and_grad(
        lambda x: jmodel.group_loss_fn({"aligned_features_stack": x, "label": jlabel}))(jnp.asarray(stack))
    x = torch.tensor(stack, requires_grad=True)
    tval = model.group_loss_fn({"aligned_features_stack": x, "label": label})
    tval.backward()
    assert model.has_group_loss() and tval.shape == ()
    np.testing.assert_allclose(tval.item(), float(jval), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **TOL)


def test_factory_resolves_the_device():
    """No device means the CUDA card, through device.resolve_device: one
    error without a card."""
    cfg = tconfig.ModelConfig.from_dict(_jax_config("clam_mlp").to_dict())
    if torch.cuda.is_available():
        assert next(ModelFactory.create_model(cfg).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModelFactory.create_model(cfg)
    assert next(ModelFactory.create_model(cfg, device="cpu").parameters()).device.type == "cpu"

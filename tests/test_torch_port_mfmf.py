"""The port's MFMF (its cross-attention layer, the model, the weight map and
the factory) against the JAX package on the CPU.

Both sides get the same weights: the JAX model is built from a seed and
its parameters go through ``mfmf_params_from_jax`` into the port's model.
Inputs come from numpy seeds; the padded window comes from the JAX
package's ``make_window`` and is vmapped on the JAX side, while the port
runs it with its leading case axis.  The JAX side runs its fused attention
in interpret mode (``attention_impl="pallas_interpret"``).  Tolerance:
rtol 1e-5, atol 1e-6 on outputs, losses and every parameter gradient (the
same float32 arithmetic summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from multimodal_fusion_tpu import config as jconfig
from multimodal_fusion_tpu.data.batching import make_window as jax_make_window
from multimodal_fusion_tpu.models import mfmf as jmfmf
from multimodal_fusion_tpu.models.base import derive_used_modalities as jax_derive
from multimodal_fusion_tpu.models.base import process_case as jax_process_case
from multimodal_fusion_tpu.models.factory import MODEL_REGISTRY as JAX_REGISTRY
from multimodal_fusion_tpu.models.factory import ModelFactory as JaxFactory
from multimodal_fusion_tpu_torch import config as tconfig
from multimodal_fusion_tpu_torch.data.batching import make_window
from multimodal_fusion_tpu_torch.models import mfmf as tmfmf
from multimodal_fusion_tpu_torch.models.base import derive_used_modalities, process_case
from multimodal_fusion_tpu_torch.models.factory import MODEL_REGISTRY, ModelFactory

CHANNELS = [
    "wsi=features", "wsi=reconstructed_features", "tma=cd3=features", "tma=cd8=features",
    "clinical=val", "clinical=mask", "blood=val", "blood=mask",
]
DIMS = {"clinical=val": 16, "blood=val": 24}
D_IN = 16


def _jax_config(impl="pallas_interpret", **extra):
    mc = jconfig.ModelConfig(model_type="mfmf", n_classes=2, input_dim=D_IN, model_size="8*4",
                             dropout=0.0, output_dim=32, channels_used_in_model=list(CHANNELS),
                             channel_input_dims=dict(DIMS))
    mc.extra.update(attention_num_heads=8, attention_impl=impl, **extra)
    return mc


def _port_config(jc, impl="auto"):
    d = jc.to_dict()
    d["attention_impl"] = impl
    return tconfig.ModelConfig.from_dict(d)


def _raw_cases(seed, n=3):
    """Ragged cases: WSI bags of 20-60 patches (and their reconstruction),
    2 TMA markers of 3-12 patches, 2 tabular groups with 0/1 masks."""
    rng = np.random.default_rng(seed)
    raws, labels = [], []
    for i in range(n):
        nw = int(rng.integers(20, 61))
        wsi = rng.standard_normal((nw, D_IN)).astype(np.float32)
        raw = {
            "wsi=features": wsi,
            "wsi=reconstructed_features": wsi + 0.1 * rng.standard_normal((nw, D_IN)).astype(np.float32),
            "tma=cd3=features": rng.standard_normal((int(rng.integers(5, 13)), D_IN)).astype(np.float32),
            "tma=cd8=features": rng.standard_normal((int(rng.integers(3, 10)), D_IN)).astype(np.float32),
        }
        for grp, dim in (("clinical", 16), ("blood", 24)):
            raw[f"{grp}=val"] = rng.standard_normal((1, dim)).astype(np.float32)
            raw[f"{grp}=mask"] = (rng.random((1, dim)) > 0.2).astype(np.float32)
        raws.append(raw)
        labels.append(i % 2)
    return raws, labels


def _torch_window(window):
    return (
        {"channels": {k: torch.as_tensor(np.array(v)) for k, v in window["channels"].items()},
         "masks": {k: torch.as_tensor(np.array(v)) for k, v in window["masks"].items()}},
        torch.as_tensor(np.array(window["label"]), dtype=torch.int64),
    )


def _pure(state):
    return nnx.to_pure_dict(state)


def _jax_window_grads(model, window):
    """Per-case logits and losses of the window, and the parameter gradients
    of sum(losses) / G, as the JAX trainer forms them (vmap over cases)."""
    graphdef, params, rest = nnx.split(model, nnx.Param, ...)
    G = window["label"].shape[0]

    def loss_fn(p):
        def one(channels, masks, label):
            m = nnx.merge(graphdef, p, rest)
            res = m({"channels": channels, "masks": masks}, label, train=True)
            return m.loss_fn(res["logits"], label[None], res), res["logits"][0]

        losses, logits = jax.vmap(one)(window["channels"], window["masks"], window["label"])
        return jnp.sum(losses) / G, (losses, logits)

    grads, (losses, logits) = jax.grad(loss_fn, has_aux=True)(params)
    return np.asarray(logits), np.asarray(losses), params, grads


@pytest.mark.parametrize("impl", ["auto", "pallas_interpret", "xla"])
def test_mfmf_forward_and_gradients_match_jax(impl):
    jc = _jax_config()
    jmodel = JaxFactory.create_model(jc, seed=0)
    raws, labels = _raw_cases(0)
    window = jax_make_window(raws, labels)
    want_logits, want_losses, params, grads = _jax_window_grads(jmodel, window)

    model = ModelFactory.create_model(_port_config(jc, impl), seed=0, device="cpu")
    model.load_state_dict(tmfmf.mfmf_params_from_jax(_pure(params)), strict=True)
    case, label = _torch_window(window)
    res = model(case, train=True)
    losses = model.loss_fn(res["logits"], label, res)
    (losses.sum() / len(labels)).backward()
    np.testing.assert_allclose(res["logits"].detach().numpy(), want_logits, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses.detach().numpy(), want_losses, rtol=1e-5, atol=1e-6)

    want_grads = tmfmf.mfmf_params_from_jax(_pure(grads))
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # the ClamMLP parts the port does not build get no gradient in JAX either
    flat = nnx.to_flat_state(grads)
    dead = [np.asarray(v[...]) for path, v in flat
            if path[0] in ("clam_branches", "transfer_layers", "fusion_fc1", "fusion_fc2")]
    assert dead and all(not g.any() for g in dead)

    # eval forward: probabilities and predictions as the JAX model's
    with torch.no_grad():
        ev = model(case, train=False)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(want_logits), axis=-1))
    np.testing.assert_allclose(ev["probabilities"].numpy(), probs, rtol=1e-5, atol=1e-6)
    assert ev["predictions"].tolist() == np.argmax(want_logits, -1).tolist()


def test_cross_attention_layer_matches_jax():
    """One pre-norm cross-attention block (widening 2, 8 heads of 4) on a
    batch of 3 padded cases, output and gradients of its parameters and
    inputs, against the JAX layer vmapped over the cases."""
    rng = np.random.default_rng(1)
    jl = jmfmf.CrossAttentionLayer(32, 8, 2, 0.0, nnx.Rngs(0))
    jl.attn_impl = "pallas_interpret"
    q = rng.standard_normal((3, 6, 32)).astype(np.float32)
    kv = rng.standard_normal((3, 40, 32)).astype(np.float32)
    mask = rng.random((3, 40)) > 0.3
    mask[2] = False  # an all-masked bag
    graphdef, params = nnx.split(jl, nnx.Param)

    def f(p, qq, kk):
        out = jax.vmap(lambda a, b, m: nnx.merge(graphdef, p)(a, b, m, train=True))(qq, kk, jnp.asarray(mask))
        return jnp.sum(out ** 2), out

    (gp, gq, gk), out = jax.grad(f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(q), jnp.asarray(kv))

    def strip(sd):
        return {k[len("attention_blocks.x."):]: v for k, v in sd.items()}

    tl = tmfmf.CrossAttentionLayer(32, 8, 2, 0.0, torch.Generator())
    tl.load_state_dict(strip(tmfmf.mfmf_params_from_jax({"attention_blocks": {"x": _pure(params)}})),
                       strict=True)
    tq, tkv = torch.as_tensor(q).requires_grad_(True), torch.as_tensor(kv).requires_grad_(True)
    got = tl(tq, tkv, torch.as_tensor(mask), train=True)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(gk), rtol=1e-5, atol=1e-6)
    want = strip(tmfmf.mfmf_params_from_jax({"attention_blocks": {"x": _pure(gp)}}))
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # one case without the case axis gives the same rows
    with torch.no_grad():
        one = tl(tq[0], tkv[0], torch.as_tensor(mask[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(out)[0], rtol=1e-5, atol=1e-6)


def test_mfmf_params_from_jax_maps_and_skips():
    jmodel = JaxFactory.create_model(_jax_config(), seed=3)
    pure = _pure(nnx.state(jmodel, nnx.Param))
    sd = tmfmf.mfmf_params_from_jax(pure)
    model = ModelFactory.create_model(_port_config(_jax_config()), seed=0, device="cpu")
    assert set(sd) == set(model.state_dict())
    k = np.asarray(pure["attention_blocks"]["result:wsi"]["q_proj"]["kernel"])
    assert torch.equal(sd["attention_blocks.result:wsi.q_proj.weight"], torch.as_tensor(k.T))
    s = np.asarray(pure["attention_blocks"]["result:wsi"]["q_norm"]["scale"])
    assert torch.equal(sd["attention_blocks.result:wsi.q_norm.weight"], torch.as_tensor(s))
    # flat tuple paths and dotted strings give the same map
    flat = {path: np.asarray(v[...]) for path, v in nnx.to_flat_state(nnx.state(jmodel, nnx.Param))}
    dotted = {".".join(map(str, p)): v for p, v in flat.items()}
    for other in (tmfmf.mfmf_params_from_jax(flat), tmfmf.mfmf_params_from_jax(dotted)):
        assert set(other) == set(sd) and all(torch.equal(other[n], sd[n]) for n in sd)


def test_mfmf_window_padding_invariance():
    """Padding a window further (the device tables' global bucket) changes
    no case's logits: every reduction is mask-aware."""
    jc = _jax_config()
    model = ModelFactory.create_model(_port_config(jc), seed=0, device="cpu")
    raws, labels = _raw_cases(4)
    small = make_window(raws, labels)
    big = make_window(raws, labels, buckets=(128,))
    assert small["channels"]["wsi=features"].shape[1] == 64
    with torch.no_grad():
        a = model(_torch_window(small)[0])["logits"]
        b = model(_torch_window(big)[0])["logits"]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_mfmf_constructor_checks_and_impls():
    with pytest.raises(ValueError, match="attention_impl"):
        ModelFactory.create_model(_port_config(_jax_config(), impl="mosaic"), seed=0, device="cpu")
    cfg = _port_config(_jax_config())
    cfg.channel_input_dims = {"clinical=val": 16}
    with pytest.raises(ValueError, match="channel_input_dims"):
        ModelFactory.create_model(cfg, seed=0, device="cpu")
    cfg = _port_config(_jax_config())
    cfg.extra["attention_num_heads"] = 5
    with pytest.raises(ValueError, match="divisible"):
        ModelFactory.create_model(cfg, seed=0, device="cpu")
    m = ModelFactory.create_model(_port_config(_jax_config(), impl="xla"), seed=0, device="cpu")
    assert [b.attn_impl for b in m.attention_blocks.values()] == ["xla"] * 3
    assert list(m.attention_blocks) == ["other:tma", "result:wsi", "reconstruct:result"]


def test_factory_registry_keys_match_jax():
    """The port's registry carries the JAX package's keys; mfmf, the ten
    keys of the flagship family, auc_clam and cox_svd_gate_random_clam
    build, every other key raises naming the ROADMAP item that ports it."""
    from multimodal_fusion_tpu_torch.models.factory import _PORTED

    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    for key in sorted(set(MODEL_REGISTRY) - set(_PORTED)):
        cfg = tconfig.ModelConfig(model_type=key)
        with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 12"):
            ModelFactory.create_model(cfg, device="cpu")
    assert len(_PORTED) == 13
    for key, cls in _PORTED.items():
        if key == "mfmf":
            continue
        cfg = tconfig.ModelConfig(model_type=key, input_dim=D_IN, model_size="8*4", output_dim=8,
                                  channels_used_in_model=["wsi=features", "tma=cd3=features"])
        assert type(ModelFactory.create_model(cfg, device="cpu")) is cls
    with pytest.raises(ValueError, match="Unknown model type"):
        ModelFactory.create_model({"model_type": "nope"}, device="cpu")
    m = ModelFactory.create_model(_port_config(_jax_config()).to_dict(), seed=0, device="cpu")
    assert isinstance(m, tmfmf.MFMF)


@pytest.mark.parametrize("seed", [0, 1])
def test_process_case_and_modalities_match_jax(seed):
    raws, labels = _raw_cases(seed, n=1)
    raw = raws[0]
    mixed = CHANNELS + ["wsi=positions", "tma_cell_density=val"]
    assert derive_used_modalities(mixed) == jax_derive(mixed)
    raw["tma_cell_density=val"] = np.ones((1, 8), np.float32)
    raw["wsi=positions"] = np.zeros((raw["wsi=features"].shape[0], 2), np.float32)
    window = make_window([raw], labels)
    got_in, got_m = process_case({"channels": {k: torch.as_tensor(v) for k, v in window["channels"].items()},
                                  "masks": {k: torch.as_tensor(v) for k, v in window["masks"].items()}},
                                 mixed)
    one = {k: {c: jnp.asarray(v[0]) for c, v in window[k].items()} for k in ("channels", "masks")}
    want_in, want_m = jax_process_case(one, mixed)
    assert set(got_in) == set(want_in) and set(got_m) == set(want_m)
    for k in want_in:
        np.testing.assert_array_equal(got_in[k][0].numpy(), np.asarray(want_in[k]))
    for k in want_m:
        np.testing.assert_array_equal(got_m[k][0].numpy(), np.asarray(want_m[k]))

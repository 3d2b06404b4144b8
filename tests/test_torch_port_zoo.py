"""The rest of the survival zoo in the port against the JAX package on the
CPU: the gate MIL family, SVDPool, MDLM, PS3, FBP, CustOmics (both node
paths), SVD-CLAM, and UniversalConnections' token matrix.

Both sides get the same weights: the JAX model is built from a seed and its
parameters go through ``survival_params_from_jax`` into the port's model
(``load_state_dict(strict=True)``: the map covers every port parameter).
The padded window comes from the JAX package's ``make_window`` over cases
drawn with numpy and is vmapped on the JAX side; the port runs it with its
leading case axis.  The training forward runs at dropout 0 without random
draws on either side (no key, no generator); its objective is the
trainer's, ``(sum of the case losses + the group loss) / G``.

Tolerances: float32 outputs, losses and gradients within rtol 1e-5, atol
1e-6 (the same float32 arithmetic summed in other orders).
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
from multimodal_fusion_tpu.utils.torch_import import import_survival_checkpoint
from multimodal_fusion_tpu_torch import config as tconfig
from multimodal_fusion_tpu_torch.models.factory import ModelFactory, survival_params_from_jax

D_IN = 16
TOL = dict(rtol=1e-5, atol=1e-6)
TABULAR = ["clinical=val", "clinical=mask", "blood=val", "blood=mask"]
BAGS = ["wsi=features", "tma=cd3=features", "tma=cd8=features"]
DIMS = {"clinical=val": D_IN, "blood=val": 24}
HG = ["hypergraph=wsi_super_features", "hypergraph=tma_features"]
# the gate MIL family weighs every channel with a Linear(D, D): its tabular
# group has the bag width, and its mask is a gated slot of its own
GATE_CHANNELS = BAGS + ["clinical=val", "clinical=mask"]

# id -> (registry key, channels, model options, node path of cust_omics)
CASES = {
    "gate_shared_mil": ("gate_shared_mil", GATE_CHANNELS, {}),
    "gate_mil": ("gate_mil", GATE_CHANNELS, {}),
    "gate_auc_mil": ("gate_auc_mil", GATE_CHANNELS, {}),
    "gate_mil_detach": ("gate_mil_detach", GATE_CHANNELS, {}),
    "svd_pool-mean": ("svd_pool", BAGS + TABULAR, {"tau1": 1.0, "tau2": 1.0, "lambda1": 0.1}),
    "svd_pool-max": ("svd_pool", BAGS + TABULAR, {"pooling_strategy": "max"}),
    "svd_pool-sum": ("svd_pool", BAGS + TABULAR, {"pooling_strategy": "sum"}),
    "mdlm": ("mdlm", BAGS + TABULAR, {}),
    "ps3": ("ps3", BAGS + TABULAR, {}),
    "fbp": ("fbp", BAGS + TABULAR, {}),
    "cust_omics-hypergraph": ("cust_omics", HG + TABULAR, {}),
    "cust_omics-raw": ("cust_omics", BAGS + TABULAR, {}),
    "svd_clam": ("svd_clam", BAGS, {"tau1": 1.0, "tau2": 1.0, "lambda2": 0.1}),
}
# the families utils/torch_import.py maps from reference checkpoints
IMPORTED = ["gate_shared_mil", "gate_mil", "gate_auc_mil", "gate_mil_detach", "svd_pool-mean",
            "mdlm", "ps3", "fbp"]


def _config(case_id, dropout=0.25):
    key, chans, extra = CASES[case_id]
    kw = dict(model_type=key, n_classes=2, input_dim=D_IN, model_size="8*4", dropout=dropout,
              output_dim=8, inst_number=8, base_weight=0.7, subtyping=True,
              channels_used_in_model=list(chans), channel_input_dims=dict(DIMS))
    mc = jconfig.ModelConfig(**kw)
    for k, v in extra.items():  # a typed field, or an extra key
        if k in jconfig.ModelConfig.__dataclass_fields__:
            setattr(mc, k, v)
        else:
            mc.extra[k] = v
    if key == "cust_omics":
        mc.extra.update(hypergraph_hidden_dims=[12, 10], hypergraph_node_dim=D_IN)
        if case_id.endswith("hypergraph"):
            mc.extra["hypergraph_tma_node_dim"] = 8  # the TMA nodes at another width
    return mc


def _raw_cases(seed, n=4):
    """Ragged cases: WSI bags of 3-40 patches (and their reconstruction), 2
    TMA markers of 2-6 patches, 2 tabular groups with 0/1 masks, and the
    build's hypergraph arrays (5-12 super-patches at D_IN, 2-5 TMA nodes at
    8, (node, hyperedge) pairs with weights, hyperedge ids as node ids)."""
    rng = np.random.default_rng(seed)
    raws, labels = [], []
    for i in range(n):
        nw = int(rng.integers(3, 41))
        wsi = rng.standard_normal((nw, D_IN)).astype(np.float32)
        raw = {"wsi=features": wsi, "wsi=reconstructed_features": wsi + 0.1}
        for mk in ("cd3", "cd8"):
            raw[f"tma={mk}=features"] = rng.standard_normal(
                (int(rng.integers(2, 7)), D_IN)).astype(np.float32)
        for grp, dim in (("clinical", D_IN), ("blood", 24)):
            raw[f"{grp}=val"] = rng.standard_normal((1, dim)).astype(np.float32)
            raw[f"{grp}=mask"] = (rng.random((1, dim)) > 0.2).astype(np.float32)
        ns, nt = int(rng.integers(5, 13)), int(rng.integers(2, 6))
        raw["hypergraph=wsi_super_features"] = rng.standard_normal((ns, D_IN)).astype(np.float32)
        raw["hypergraph=tma_features"] = rng.standard_normal((nt, 8)).astype(np.float32)
        pairs = int(rng.integers(8, 30))
        raw["hypergraph=edge_index"] = rng.integers(0, ns + nt, (2, pairs)).astype(np.int64)
        raw["hypergraph=edge_weights"] = rng.uniform(0.1, 1.0, pairs).astype(np.float32)
        raws.append(raw)
        labels.append(i % 2)
    return raws, labels


def _window(seed, case_id):
    """The window of ``_raw_cases(seed)``; the hypergraph arrays only for
    the case that reads them (CustOmics takes its node path from the
    window's channels)."""
    raws, labels = _raw_cases(seed)
    if not case_id.endswith("hypergraph"):
        raws = [{k: v for k, v in r.items() if not k.startswith("hypergraph=")} for r in raws]
    return make_window(raws, labels)


def _port_window(window):
    put = lambda v: torch.as_tensor(np.array(v))  # noqa: E731
    case = {"channels": {k: put(v) for k, v in window["channels"].items()},
            "masks": {k: put(v) for k, v in window["masks"].items()}}
    return case, torch.as_tensor(np.array(window["label"]), dtype=torch.int64)


def _pure(state):
    return nnx.to_pure_dict(state)


def _port_model(mc, jmodel):
    model = ModelFactory.create_model(tconfig.ModelConfig.from_dict(mc.to_dict()), seed=1,
                                      device="cpu")
    model.load_state_dict(survival_params_from_jax(_pure(nnx.state(jmodel, nnx.Param))), strict=True)
    return model


def _per_case(res, key):
    """A JAX per-case entry [G, 1, ...] -> [G, ...] (scalars stay [G])."""
    a = np.asarray(res[key], np.float32)
    return a[:, 0] if a.ndim >= 2 and a.shape[1] == 1 else a


def _jax_window(graphdef, params, rest, window, train):
    """The JAX model vmapped over the window: (results, per-case losses)."""
    def one(c, m, label):
        mm = nnx.merge(graphdef, params, rest)
        res = mm({"channels": c, "masks": m}, label, train=train)
        return res, mm.loss_fn(res["logits"], label[None], res)

    return jax.vmap(one)(window["channels"], window["masks"], window["label"])


@pytest.mark.parametrize("case_id", list(CASES))
def test_eval_forward_matches_jax(case_id):
    mc = _config(case_id)
    jmodel = JaxFactory.create_model(mc, seed=0)
    window = _window(3, case_id)
    graphdef, params, rest = nnx.split(jmodel, nnx.Param, ...)
    want, want_loss = jax.jit(lambda p: _jax_window(graphdef, p, rest, window, train=False))(params)
    model = _port_model(mc, jmodel)
    case, label = _port_window(window)
    with torch.no_grad():
        got = model(case, label)
        loss = model.loss_fn(got["logits"], label, got)
    np.testing.assert_allclose(got["logits"].numpy(), _per_case(want, "logits"), **TOL)
    np.testing.assert_allclose(got["probabilities"].numpy(), _per_case(want, "probabilities"), **TOL)
    np.testing.assert_array_equal(got["predictions"].numpy(), _per_case(want, "predictions"))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    for k in want:  # every loss, the moe weights, the SVD inputs and values
        if k.endswith("_loss") or k in ("moe_weights", "aligned_features_stack", "svd_values"):
            np.testing.assert_allclose(got[k].numpy(), _per_case(want, k), err_msg=k, **TOL)
    if mc.model_type == "svd_clam":
        assert got["svd_loss"].shape == (4,) and got["svd_values"].shape == (4, 2)


@pytest.mark.parametrize("case_id", list(CASES))
def test_train_forward_and_gradients_match_jax(case_id):
    """train=True at dropout 0 with no draws on either side: per-case
    losses, the group loss and every parameter's gradient of the
    trainer's window objective."""
    mc = _config(case_id, dropout=0.0)
    jmodel = JaxFactory.create_model(mc, seed=2)
    window = _window(5, case_id)
    graphdef, params, rest = nnx.split(jmodel, nnx.Param, ...)
    G = len(window["label"])

    def objective(p):
        res, losses = _jax_window(graphdef, p, rest, window, train=True)
        total = jnp.sum(losses)
        mm = nnx.merge(graphdef, p, rest)
        if mm.has_group_loss():
            total = total + mm.group_loss_fn(dict(res, label=jnp.asarray(window["label"])))
        return total / G, losses

    grads, want_loss = jax.jit(jax.grad(objective, has_aux=True))(params)
    model = _port_model(mc, jmodel)
    case, label = _port_window(window)
    res = model(case, label, train=True)
    losses = model.loss_fn(res["logits"], label, res)
    total = losses.sum()
    if model.has_group_loss():
        total = total + model.group_loss_fn(dict(res, label=label))
    (total / G).backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_loss), **TOL)
    want_grads = survival_params_from_jax(_pure(grads))
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("case_id", IMPORTED)
def test_port_state_dict_imports_into_jax(case_id):
    """port -> JAX: ``import_survival_checkpoint`` reads the port's
    ``state_dict`` as a reference checkpoint and consumes every key (but
    AUCM's a, b and alpha, which the reference keeps in its loss object,
    not in the model's ``state_dict``); JAX -> port gives the same tensors
    back."""
    mc = _config(case_id)
    model = _port_model(mc, JaxFactory.create_model(mc, seed=0))
    other = JaxFactory.create_model(mc, seed=9)
    sd = model.state_dict()
    left = import_survival_checkpoint(other, sd)
    assert left == (["auc_a", "auc_alpha", "auc_b"] if mc.model_type == "gate_auc_mil" else [])
    back = survival_params_from_jax(_pure(nnx.state(other, nnx.Param)))
    assert set(back) == set(sd)
    for name in sd:
        assert torch.equal(back[name], sd[name]), name


def test_auto_connections_token_matrix_matches_jax():
    """UniversalConnections returns the grown token matrix [G, M + depth *
    views, token_dim], not a result dict; exact GELU, Xavier-uniform W."""
    mc = _config("ps3")
    mc.model_type = "auto_connections"
    mc.extra.update(views_num=3, inference_depth=2)
    jmodel = JaxFactory.create_model(mc, seed=0)
    window = _window(7, "ps3")
    graphdef, state = nnx.split(jmodel)

    @jax.jit
    def tokens(state):
        def one(c, m, label):
            return nnx.merge(graphdef, state)({"channels": c, "masks": m}, label)

        return jax.vmap(one)(window["channels"], window["masks"], window["label"])

    want = np.asarray(tokens(state))
    model = _port_model(mc, jmodel)
    with torch.no_grad():
        got = model(*_port_window(window))
    assert got.shape == want.shape == (4, 4 + 2 * 3, 8)  # 4 modalities, 2 x 3 views
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    fresh = ModelFactory.create_model(tconfig.ModelConfig.from_dict(mc.to_dict()), device="cpu")
    bound = (6.0 / 16) ** 0.5
    assert all(float(w.detach().abs().max()) <= bound for w in fresh.Wq)


def test_gate_shared_mil_holds_one_module_set():
    """The shared variant holds one set of parameters, not a copy per
    channel; the per-channel variants hold one per channel."""
    shared = ModelFactory.create_model(
        tconfig.ModelConfig.from_dict(_config("gate_shared_mil").to_dict()), device="cpu")
    per = ModelFactory.create_model(
        tconfig.ModelConfig.from_dict(_config("gate_mil").to_dict()), device="cpu")
    names = set(shared.state_dict())
    assert {"ChannelFeatureWeightor.0.weight", "TCPClassifier.6.bias",
            "TCPConfidenceLayer.2.weight", "classifiers.9.weight"} <= names
    assert not any(n.startswith("TCPClassifier.wsi") for n in names)
    n_channels = len(GATE_CHANNELS)
    head = sum(p.numel() for n, p in shared.named_parameters() if n.startswith("classifiers."))
    per_set = sum(p.numel() for p in shared.parameters()) - head
    assert sum(p.numel() for p in per.parameters()) - head == n_channels * per_set
    assert "TCPConfidenceLayer.clinical=mask.0.weight" in per.state_dict()


def test_svd_pool_refuses_partial_alignment_and_bad_pooling():
    mc = tconfig.ModelConfig.from_dict(_config("svd_pool-mean").to_dict())
    mc.alignment_channels = ["wsi=features"]
    with pytest.raises(ValueError, match="aligns every used modality"):
        ModelFactory.create_model(mc, device="cpu")
    mc = tconfig.ModelConfig.from_dict(_config("svd_pool-mean").to_dict())
    mc.extra["pooling_strategy"] = "median"
    with pytest.raises(ValueError, match="Unsupported pooling"):
        ModelFactory.create_model(mc, device="cpu")

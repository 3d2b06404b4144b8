"""Weights of the JAX package's models for the port: the survival zoo
(:func:`survival_params_from_jax`, re-exported by ``models.factory`` and
``models.svd_gate``), the alignment model (:func:`alignment_params_from_jax`)
and the VAE (:func:`vae_params_from_jax`).

The port's parameters carry the reference ``state_dict`` names, which
``multimodal_fusion_tpu.utils.torch_import`` reads; :data:`JAX_TO_PORT`
maps each JAX module path onto them.  For the three models that the JAX
package does not map (``cust_omics``, ``svd_clam``, ``auto_connections``)
the port's names are its own, given in the table below and in each model's
module docstring.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# JAX module path -> the port's module name; "<ch>" and "<i>" match any one
# path element (a channel key, a list index) and carry it across.  The
# first pattern that matches wins, so literal elements come before the
# wildcards that would also take them.
JAX_TO_PORT = (
    # ClamMLP trunk and its CLAM branches
    (("clam_branches", "<ch>", "core", "fc"), "attention_net.<ch>.0"),
    (("clam_branches", "<ch>", "core", "attn", "fc_a"), "attention_net.<ch>.3.attention_a.0"),
    (("clam_branches", "<ch>", "core", "attn", "fc_b"), "attention_net.<ch>.3.attention_b.0"),
    (("clam_branches", "<ch>", "core", "attn", "fc_c"), "attention_net.<ch>.3.attention_c"),
    (("clam_branches", "<ch>", "core", "attn", "fc1"), "attention_net.<ch>.3.module.0"),
    (("clam_branches", "<ch>", "core", "attn", "fc2"), "attention_net.<ch>.3.module.3"),
    (("clam_branches", "<ch>", "transfer"), "transfer_layer.<ch>"),
    (("clam_branches", "<ch>", "classifier"), "classifiers.<ch>"),
    (("clam_branches", "<ch>", "instance_classifiers", "<i>"), "instance_classifiers.<ch>.<i>"),
    (("transfer_layers", "<ch>"), "transfer_layer.<ch>"),
    (("fusion_fc1",), "fusion_prediction.0"),
    (("fusion_fc2",), "fusion_prediction.1"),
    # svd_gate family (TCP gate, alignment, deep supervision) and Cox
    (("tcp_classifiers", "__shared__", "fc1"), "TCPClassifier.0"),
    (("tcp_classifiers", "__shared__", "fc2"), "TCPClassifier.3"),
    (("tcp_classifiers", "__shared__", "fc3"), "TCPClassifier.6"),
    (("tcp_classifiers", "<ch>", "fc1"), "TCPClassifier.<ch>.0"),
    (("tcp_classifiers", "<ch>", "fc2"), "TCPClassifier.<ch>.3"),
    (("tcp_classifiers", "<ch>", "fc3"), "TCPClassifier.<ch>.6"),
    (("tcp_confidence", "<ch>", "fc1"), "TCPConfidenceLayer.<ch>.0"),
    (("tcp_confidence", "<ch>", "fc2"), "TCPConfidenceLayer.<ch>.1"),
    (("tcp_confidence", "<ch>", "fc3"), "TCPConfidenceLayer.<ch>.2"),
    (("alignment_layers", "<ch>", "layers", "<i>"), "alignment_layers.<ch>.<i>"),
    (("ds_classifiers", "<ch>", "fc1"), "Classifier.<ch>.0"),
    (("ds_classifiers", "<ch>", "fc2"), "Classifier.<ch>.3"),
    (("risk_head",), "risk_head"),
    (("risk_head_logits",), "risk_head_logits"),
    # CLAM (MIL's ``fc`` and CLAM's ``classifier`` in _port_prefix)
    (("core", "fc"), "attention_net.0"),
    (("core", "attn", "fc_a"), "attention_net.3.attention_a.0"),
    (("core", "attn", "fc_b"), "attention_net.3.attention_b.0"),
    (("core", "attn", "fc_c"), "attention_net.3.attention_c"),
    (("core", "attn", "fc1"), "attention_net.3.module.0"),
    (("core", "attn", "fc2"), "attention_net.3.module.3"),
    (("instance_classifiers", "<i>"), "instance_classifiers.<i>"),
    # gate MIL family (shared modules: no channel level)
    (("feature_weightors", "__shared__", "fc"), "ChannelFeatureWeightor.0"),
    (("feature_weightors", "<ch>", "fc"), "ChannelFeatureWeightor.<ch>.0"),
    (("tcp_confidences", "__shared__", "fc1"), "TCPConfidenceLayer.0"),
    (("tcp_confidences", "__shared__", "fc2"), "TCPConfidenceLayer.1"),
    (("tcp_confidences", "__shared__", "fc3"), "TCPConfidenceLayer.2"),
    (("tcp_confidences", "<ch>", "fc1"), "TCPConfidenceLayer.<ch>.0"),
    (("tcp_confidences", "<ch>", "fc2"), "TCPConfidenceLayer.<ch>.1"),
    (("tcp_confidences", "<ch>", "fc3"), "TCPConfidenceLayer.<ch>.2"),
    (("fusion_classifier", "fc1"), "classifiers.0"),
    (("fusion_classifier", "fc2"), "classifiers.3"),
    (("fusion_classifier", "fc3"), "classifiers.6"),
    (("fusion_classifier", "fc4"), "classifiers.9"),
    # PS3
    (("token_norm",), "token_norm"),
    (("qkv_proj",), "qkv_proj"),
    (("modality_mlps", "<ch>"), "modality_mlp_layers.<ch>"),
    (("fusion_fc_a",), "modality_fusion_layer.0"),
    (("fusion_fc_b",), "modality_fusion_layer.3"),
    # FBP (its ``head`` in _port_prefix)
    (("bilinear",), "modality_bilinear_fusion_layer"),
    (("modality_moe",), "modality_moe_fusion_layer"),
    (("moe",), "moe_fusion_layer"),
    # MDLM, SVDPool
    (("prediction_heads", "<ch>"), "prediction_head_dict.<ch>"),
    (("late_fusion",), "late_fusion_layer"),
    (("pool_head",), "fusion_prediction"),
    # CustOmics (no JAX map: torch_geometric's names where it has them)
    (("hypergraph_net", "first"), "hypergraph_net.first"),
    (("hypergraph_net", "bn"), "hypergraph_net.bn"),
    (("hypergraph_net", "convs", "<i>", "lin"), "hypergraph_net.convs.<i>.lin"),
    (("hypergraph_net", "convs", "<i>"), "hypergraph_net.convs.<i>"),
    (("hypergraph_net", "out_layer"), "hypergraph_net.out_layer"),
    (("hypergraph_net", "pool", "gate_fc1"), "hypergraph_net.pool.gate_nn.0"),
    (("hypergraph_net", "pool", "gate_fc2"), "hypergraph_net.pool.gate_nn.2"),
    (("moe_gate",), "moe_gate"),
    (("head",), "head"),
    (("hypergraph_transfer",), "hypergraph_transfer"),
    (("hypergraph_tma_transfer",), "hypergraph_tma_transfer"),
    # SVDCLAM (no JAX map: the reference alignment model's names)
    (("alignment_model", "alignment_layers", "<ch>", "<i>"), "alignment_model.alignment_layers.<ch>.<i>"),
    (("alignment_model", "mlp_predictor", "fc1"), "alignment_model.mlp_predictor.mlp.0"),
    (("alignment_model", "mlp_predictor", "fc2"), "alignment_model.mlp_predictor.mlp.3"),
    # UniversalConnections (no JAX map: the JAX package's names)
    (("q_gen", "<i>"), "q_gen.<i>"),
    (("post_fc1", "<i>"), "post_fc1.<i>"),
    (("post_fc2", "<i>"), "post_fc2.<i>"),
)

# parameters that are a whole path, with no leaf name: the same name in the
# port
_DIRECT = (("clip_logit_scale",), ("auc_a",), ("auc_b",), ("auc_alpha",),
           ("Wq", "<i>"), ("Wk", "<i>"), ("Wv", "<i>"))


def _flatten(state: Mapping, prefix=()) -> Dict[tuple, object]:
    out = {}
    for key, value in state.items():
        path = prefix + (key if isinstance(key, tuple) else (key,))
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def flat_jax(state: Mapping) -> Dict[Tuple[str, ...], np.ndarray]:
    """{path tuple: float32 array} of JAX parameters given as a nested pure
    dict (``nnx.to_pure_dict(nnx.state(model, nnx.Param))``) or flat with
    tuple or ``.``- or ``/``-joined string paths."""
    out = {}
    for key, value in _flatten(state).items():
        parts = tuple(str(p) for p in key)
        if len(parts) == 1:
            parts = tuple(parts[0].replace("/", ".").split("."))
        out[parts] = np.asarray(value, dtype=np.float32)
    return out


def port_leaf(name: str, arr: np.ndarray) -> Tuple[str, torch.Tensor]:
    """The port's (name, tensor) of the JAX leaf at the dotted path
    ``name``: a Linear ``kernel`` [in, out] becomes ``weight`` [out, in], a
    norm's ``scale`` its ``weight``; any other leaf keeps its name."""
    prefix, _, leaf = name.rpartition(".")
    if leaf == "kernel":
        return f"{prefix}.weight", torch.from_numpy(arr.T.copy())
    if leaf == "scale":
        return f"{prefix}.weight", torch.from_numpy(arr.copy())
    return name, torch.from_numpy(arr.copy())


def _match(pattern: Tuple[str, ...], path: Tuple[str, ...], target: str):
    """``target`` with the wildcards of ``pattern`` filled from ``path``,
    or None when ``path`` does not match."""
    if len(pattern) != len(path):
        return None
    for want, got in zip(pattern, path):
        if want in ("<ch>", "<i>"):
            target = target.replace(want, got, 1)
        elif want != got:
            return None
    return target


def _port_prefix(module_path: Tuple[str, ...], family: str) -> str:
    if module_path == ("classifier",):  # CLAM's bag classifier; MIL's keeps its name
        return "classifiers" if family == "clam" else "classifier"
    if module_path == ("fc",):  # MIL
        return "fc.0"
    if module_path == ("head",) and family == "fbp":
        return "fusion_prediction_layer"
    for pattern, target in JAX_TO_PORT:
        name = _match(pattern, module_path, target)
        if name is not None:
            return name
    raise KeyError(f"no port parameter for the JAX parameter {'.'.join(module_path)}")


def _family(paths) -> str:
    """The JAX model kind where the map depends on it."""
    firsts = {p[0] for p in paths}
    for first, family in (("core", "clam"), ("bilinear", "fbp"), ("pool_head", "svd_pool"),
                          ("prediction_heads", "mdlm")):
        if first in firsts:
            return family
    return ""


def _dead_in_port(parts: Tuple[str, ...], family: str) -> bool:
    """JAX parameters the port's model does not have, as the reference's
    does not: SVDPool's inherited two-layer fusion head (its own head
    replaces it) and MDLM's tabular transfer layers (its forward reads those
    channels raw)."""
    if family == "svd_pool":
        return parts[0] in ("fusion_fc1", "fusion_fc2")
    return family == "mdlm" and parts[0] == "transfer_layers"


def survival_params_from_jax(state: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict of any survival model of the zoo (every key of
    the factory but ``mfmf``) from the JAX model's parameters, given as a
    nested pure dict (``nnx.to_pure_dict(nnx.state(model, nnx.Param))``) or
    flat ``{path: array}`` with tuple or dotted-string paths.  Linear
    ``kernel`` [in, out] becomes ``weight`` [out, in], a norm's ``scale``
    its ``weight``; names follow :data:`JAX_TO_PORT`.  Load with
    ``model.load_state_dict``."""
    flat = flat_jax(state)
    family = _family(flat)
    out: Dict[str, torch.Tensor] = {}
    for parts, arr in flat.items():
        if _dead_in_port(parts, family):
            continue
        direct = next((name for pattern in _DIRECT
                       if (name := _match(pattern, parts, ".".join(pattern))) is not None), None)
        name, tensor = port_leaf(direct or f"{_port_prefix(parts[:-1], family)}.{parts[-1]}", arr)
        out[name] = tensor
    return out


def _linear_state(flat: Dict[Tuple[str, ...], np.ndarray], name_of) -> Dict[str, torch.Tensor]:
    """Linear layers as the port's parameters (``port_leaf``); ``name_of``
    maps a JAX module path to the port's module name."""
    return dict(port_leaf(f"{name_of(parts[:-1])}.{parts[-1]}", arr) for parts, arr in flat.items())


def alignment_params_from_jax(state: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``MultiModalAlignmentModel`` state dict from the JAX
    model's parameters (``alignment_layers/<m>/<i>`` ->
    ``alignment_layers.<m>.<i>``, ``mlp_predictor/fc1|fc2`` ->
    ``mlp_predictor.mlp.0|3``: the reference ``state_dict`` names)."""
    predictor = {"fc1": "mlp_predictor.mlp.0", "fc2": "mlp_predictor.mlp.3"}

    def name_of(path):
        if path[0] == "mlp_predictor":
            return predictor[path[1]]
        return ".".join(path)

    return _linear_state(flat_jax(state), name_of)


def vae_params_from_jax(state: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``VAE`` state dict from the JAX VAE's parameters: hidden
    layer i of either half at ``<half>.<half>.<3i>`` (reference
    Sequential(Linear, GELU, Dropout, ...) indices), the decoder's output
    layer last in ``decoder.decoder``, ``encoder.fc_mean`` and
    ``encoder.fc_log_var`` as they are."""
    flat = flat_jax(state)
    n_dec = len({p[2] for p in flat if p[:2] == ("decoder", "layers")})

    def name_of(path):
        if path[1] == "layers":
            return f"{path[0]}.{path[0]}.{3 * int(path[2])}"
        if path == ("decoder", "out"):
            return f"decoder.decoder.{3 * n_dec - 1}"
        return ".".join(path)

    return _linear_state(flat, name_of)

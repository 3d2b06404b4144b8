"""MFMF (Perceiver-IO-style cross-attention fusion of WSI, TMA and tabular
tokens), plain: one case at a time over its valid tokens only, with
autograd for the gradients and Adam with coupled L2 written out.

The model (``downstream_survival/models/mfmf.py`` as the repo's packages
run it): every channel goes through its own Linear to ``output_dim``
tokens; the WSI bag is the ``wsi`` modality, its reconstruction
``reconstruct``, the TMA markers' tokens together ``tma``, the tabular
channels' one token each together ``other``.  Each fusion block is a
pre-norm cross attention (LayerNorm of q and of kv, q/k/v projections,
softmax(q k^T / sqrt(hd)) v over ``attention_num_heads`` heads, an output
projection added to q) and a pre-norm MLP (Linear, exact GELU, Linear),
residual; its output becomes ``result``.  The last block's tokens are
averaged, a Linear gives the logits, the loss is the cross entropy.  A
window's loss is the sum of its cases' over the window's size.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness.draw import WeightSpec
from portbench.reference import kernels
from portbench.reference.numerics import Numerics, layer_norm

# torch.optim.Adam's defaults, which the reference trainer's Adam takes
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
BLOCK_LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj")
BLOCK_NORMS = ("q_norm", "kv_norm", "mlp_norm")


def _dims(model: Dict):
    d = int(model["output_dim"])
    heads = int(model.get("attention_num_heads", 8))
    return d, heads, d // heads, int(model.get("attention_widening_factor", 1))


def _blocks(model: Dict) -> List[Dict[str, str]]:
    return list(model["fusion_blocks_sequence"])


def _in_dim(model: Dict, ch: str) -> int:
    if ch.startswith(("wsi=", "tma=")):
        return int(model["input_dim"])
    return int(model["channel_input_dims"][ch])


def _value_channels(model: Dict) -> List[str]:
    return [ch for ch in model["channels_used_in_model"] if not ch.endswith("=mask")]


def weight_spec(config: Dict) -> WeightSpec:
    """Every parameter under the name the port's state dict gives it.
    Linear weights and biases uniform in +-1/sqrt(fan_in) (torch's
    default); LayerNorm scales around 1 and shifts around 0, as a trained
    model has them."""
    model = config["model"]
    d, _, _, widen = _dims(model)
    spec: WeightSpec = []

    def linear(prefix: str, fan_in: int, fan_out: int):
        bound = 1.0 / math.sqrt(fan_in)
        spec.append((f"{prefix}.weight", (fan_out, fan_in), "uniform", -bound, bound))
        spec.append((f"{prefix}.bias", (fan_out,), "uniform", -bound, bound))

    for blk in _blocks(model):
        prefix = f"attention_blocks.{blk['q']}:{blk['kv']}"
        for norm in BLOCK_NORMS:
            spec.append((f"{prefix}.{norm}.weight", (d,), "normal", 1.0, 0.1))
            spec.append((f"{prefix}.{norm}.bias", (d,), "normal", 0.0, 0.02))
        for name in BLOCK_LINEARS:
            linear(f"{prefix}.{name}", d, d)
        linear(f"{prefix}.mlp_fc1", d, widen * d)
        linear(f"{prefix}.mlp_fc2", widen * d, d)
    for ch in _value_channels(model):
        linear(f"mfmf_transfer.{ch}", _in_dim(model, ch), d)
    linear("head", d, int(model["n_classes"]))
    return spec


def case_inputs(tables: Dict, lengths: Dict[str, np.ndarray], row: int) -> Dict[str, torch.Tensor]:
    """One case's channels from the cohort's tables, valid rows only."""
    out = {}
    for ch, t in tables["channels"].items():
        n = int(lengths[ch][row]) if ch in lengths else t.shape[1]
        out[ch] = t[row, :n]
    return out


def _modalities(w: Dict[str, torch.Tensor], model: Dict, inputs: Dict[str, torch.Tensor],
                num: Numerics) -> Dict[str, torch.Tensor]:
    tma, other, out = [], [], {}
    for ch in _value_channels(model):
        x = inputs[ch]
        mask_ch = f"{ch.split('=')[0]}=mask"
        if not ch.startswith(("wsi=", "tma=")) and mask_ch in inputs:
            x = x * inputs[mask_ch]
        tok = num.linear(x, w[f"mfmf_transfer.{ch}.weight"], w[f"mfmf_transfer.{ch}.bias"])
        if ch == "wsi=features":
            out["wsi"] = tok
        elif ch == "wsi=reconstructed_features":
            out["reconstruct"] = tok
        elif ch.startswith("tma="):
            tma.append(tok)
        else:
            other.append(tok)
    if tma:
        out["tma"] = torch.cat(tma)
    if other:
        out["other"] = torch.cat(other)
    return out


def _cross_block(w: Dict[str, torch.Tensor], prefix: str, q: torch.Tensor, kv: torch.Tensor,
                 heads: int, eps: float, num: Numerics) -> torch.Tensor:
    def lin(x, name):
        return num.linear(x, w[f"{prefix}.{name}.weight"], w[f"{prefix}.{name}.bias"])

    def norm(x, name):
        return layer_norm(x, w[f"{prefix}.{name}.weight"], w[f"{prefix}.{name}.bias"], eps)

    n_q, d = q.shape
    hd = d // heads
    qn, kvn = norm(q, "q_norm"), norm(kv, "kv_norm")
    qh = lin(qn, "q_proj").view(n_q, heads, hd).transpose(0, 1)  # [H, Nq, hd]
    kh = lin(kvn, "k_proj").view(-1, heads, hd).transpose(0, 1)
    vh = lin(kvn, "v_proj").view(-1, heads, hd).transpose(0, 1)
    p = torch.softmax(num.matmul(qh, kh.transpose(1, 2)) / math.sqrt(hd), dim=-1)
    o = num.matmul(p, vh).transpose(0, 1).reshape(n_q, d)
    x = q + lin(o, "out_proj")
    return x + lin(F.gelu(lin(norm(x, "mlp_norm"), "mlp_fc1")), "mlp_fc2")


def logits(w: Dict[str, torch.Tensor], config: Dict, inputs: Dict[str, torch.Tensor],
           num: Numerics) -> torch.Tensor:
    """One case's logits [C]."""
    model = config["model"]
    _, heads, _, _ = _dims(model)
    eps = float(model["layer_norm_eps"])
    tokens = _modalities(w, model, inputs, num)
    for blk in _blocks(model):
        prefix = f"attention_blocks.{blk['q']}:{blk['kv']}"
        tokens["result"] = _cross_block(w, prefix, tokens[blk["q"]], tokens[blk["kv"]], heads, eps,
                                        num)
    return num.linear(tokens["result"].mean(dim=0), w["head.weight"], w["head.bias"])


def train(weights: Dict[str, torch.Tensor], config: Dict, tables: Dict,
          lengths: Dict[str, np.ndarray], labels: np.ndarray, windows: Sequence[Sequence[int]],
          tf32: bool = False) -> Dict:
    """Train from ``weights`` over ``windows`` (rows of the cohort), one
    Adam step with coupled L2 each, as torch.optim.Adam(weight_decay=...)
    steps.  Returns each window's mean case loss, the norm of each leaf of
    the first step's gradient as the optimizer takes it (the loss's plus
    weight_decay * p) and of the loss's gradient alone, and the norm of each
    leaf's change after all the windows."""
    exp = config["experiment"]
    lr, wd = float(exp["lr"]), float(exp["weight_decay"])
    b1, b2 = ADAM_BETAS
    num = Numerics(tf32)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first, first_raw = [], {}, {}
    with num.active():
        for t, rows in enumerate(windows, start=1):
            for p in params.values():
                p.grad = None
            total = 0.0
            for r in rows:
                out = logits(params, config, case_inputs(tables, lengths, int(r)), num)
                loss = torch.logsumexp(out, 0) - out[int(labels[int(r)])]
                (loss / len(rows)).backward()
                total += float(loss.detach())
            losses.append(total / len(rows))
            with torch.no_grad():
                for k, p in params.items():
                    g = p.grad + wd * p
                    if t == 1:
                        first[k] = float(g.norm())
                        first_raw[k] = float(p.grad.norm())
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = v2[k].sqrt() / math.sqrt(1 - b2 ** t) + ADAM_EPS
                    p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    change = {k: float((params[k].detach() - weights[k]).norm()) for k in params}
    return {"losses": losses, "grad": first, "grad_raw": first_raw, "change": change}


def _block_flops(d: int, widen: int, n_q: np.ndarray, n_k: np.ndarray) -> np.ndarray:
    """Forward FLOPs of one fusion block per case: the q, out and MLP
    projections over the queries, k and v over the keys, and the attention."""
    return (2 * d * d * (2 + 2 * widen) * n_q + 4 * d * d * n_k + 4 * d * n_q * n_k).astype(float)


def count(config: Dict, window: Dict) -> Dict:
    """The work of one training step over ``window``: its cases' valid
    lengths (``wsi`` [G], ``tma`` [G, M]) and the padded lengths the
    program runs (``pad``).  Useful FLOPs count valid tokens only, the
    backward twice the forward and nothing for the transfer layers' inputs;
    each fusion block is one K3 launch and one K4 call at the padded shapes
    with the kept keys."""
    model = config["model"]
    d, heads, hd, widen = _dims(model)
    din = int(model["input_dim"])
    tabular = [ch for ch in _value_channels(model) if not ch.startswith(("wsi=", "tma="))]
    n_wsi_channels = sum(ch.startswith("wsi=") for ch in _value_channels(model))
    n_w = np.asarray(window["wsi"], dtype=float)
    n_t = np.asarray(window["tma"], dtype=float).sum(axis=1)
    g = len(n_w)
    valid = {"wsi": n_w, "reconstruct": n_w, "tma": n_t, "other": np.full(g, float(len(tabular)))}
    # the TMA modality is every marker's padded bag, one after another
    padded = {"wsi": window["pad"]["wsi"], "reconstruct": window["pad"]["wsi"],
              "tma": window["pad"]["tma"] * np.shape(window["tma"])[1], "other": len(tabular)}
    masked = {"wsi": True, "reconstruct": True, "tma": True, "other": False}
    transfer = (2 * din * d * (n_wsi_channels * n_w + n_t)).sum()
    transfer += g * sum(2 * _in_dim(model, ch) * d for ch in tabular)
    blocks = 2 * d * int(model["n_classes"]) * g
    k3, k4 = [], []
    for blk in _blocks(model):
        q, kv = blk["q"], blk["kv"]
        blocks += _block_flops(d, widen, valid[q], valid[kv]).sum()
        shape = (g, heads, padded[q], padded[kv], hd, 4)
        kept = int(valid[kv].sum())
        k3.append(kernels.attention_fwd(*shape, kept_keys=kept, masked=masked[kv]))
        k4.append(kernels.attention_bwd(*shape, kept_keys=kept, masked=masked[kv]))
        valid["result"], padded["result"], masked["result"] = valid[q], padded[q], masked[q]
    return {"flops": float(2 * transfer + 3 * blocks), "kernels": {"k3": k3, "k4": k4}}

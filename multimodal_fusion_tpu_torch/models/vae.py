"""Patch-embedding VAE (counterpart of ``multimodal_fusion_tpu.models.vae``).

Reference: ``vae/models.py:11-211`` (MLP encoder [512, 256] -> latent 128
with exact GELU and Dropout(0.1) on the intermediate layers, a mirrored
decoder, the reparameterisation) and ``vae/loss.py:15-70`` (L = MSE + KLD).

Parameters carry the reference ``state_dict`` names, which
``multimodal_fusion_tpu.utils.torch_import.import_vae_checkpoint`` reads:
hidden layer i of either half at ``encoder.encoder.<3i>`` /
``decoder.decoder.<3i>`` (the reference Sequential's Linear, GELU, Dropout
indices), ``encoder.fc_mean``, ``encoder.fc_log_var``, and the decoder's
output layer last in ``decoder.decoder``.

Random numbers: dropout keep masks and the reparameterisation's noise come
from a ``torch.Generator`` (on its own device), or are given explicitly as
``draws`` (a test feeds the draws the JAX side made).  Without a generator
and draws the forward encodes to the mean; dropout runs only in training.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_fusion_tpu_torch.models.common import torch_linear

DROPOUT = 0.1
Draws = Dict[str, object]  # {"encoder": [keep masks], "eps": tensor, "decoder": [keep masks]}


def infer_vae_arch(checkpoint_path) -> tuple:
    """(input_dim, encoder_hidden, decoder_hidden, latent_dim) of a saved
    VAE (a ``save_model`` file or a ``VAETrainer`` checkpoint), read from
    its ``encoder.encoder.<i>`` / ``decoder.decoder.<i>`` / ``fc_mean``
    weights."""
    enc, dec, latent = {}, {}, None
    with np.load(checkpoint_path, allow_pickle=False) as data:
        for k in data.files:
            m = re.search(r"(?:^|/)(encoder|decoder)\.\1\.(\d+)\.weight$", k)
            if m:
                (enc if m.group(1) == "encoder" else dec)[int(m.group(2))] = data[k].shape
            elif re.search(r"(?:^|/)encoder\.fc_mean\.weight$", k):
                latent = int(data[k].shape[0])
    if not enc or len(dec) < 2 or latent is None:
        # an encoder-only or truncated file fails here, not later with a
        # confusing shape error
        raise ValueError(f"{checkpoint_path} does not look like a complete VAE checkpoint "
                         "(need encoder.encoder, encoder.fc_mean and decoder.decoder weights)")
    dec_idx = sorted(dec)
    return (int(enc[min(enc)][1]), [int(enc[i][0]) for i in sorted(enc)],
            [int(dec[i][0]) for i in dec_idx[:-1]], latent)


def _mlp(dims: Sequence[int], generator: torch.Generator) -> nn.ModuleDict:
    """Linear layers at the reference Sequential's indices: 3i for layer i
    (Linear, GELU, Dropout), the layer after the last hidden one at 3n - 1."""
    return nn.ModuleDict({str(3 * i): torch_linear(dims[i], dims[i + 1], generator)
                          for i in range(len(dims) - 1)})


def _hidden(layers: List[nn.Linear], h: torch.Tensor, masks: Optional[Sequence[torch.Tensor]],
            generator: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """Linear + exact GELU per layer, dropout after every layer but the last
    (training only), keep masks from ``masks`` or drawn from ``generator``."""
    keep = 1.0 - DROPOUT
    for i, layer in enumerate(layers):
        h = F.gelu(layer(h), approximate="none")
        if train and i < len(layers) - 1:
            if masks is not None:
                mask = masks[i]
            elif generator is not None:
                mask = torch.rand(h.shape, generator=generator, device=generator.device) < keep
            else:
                continue
            h = torch.where(mask.to(h.device), h / keep, 0.0)
    return h


class Encoder(nn.Module):
    def __init__(self, input_dim: int, hidden_dims: Optional[List[int]], latent_dim: int,
                 generator: torch.Generator):
        super().__init__()
        hidden_dims = hidden_dims or [512, 256]
        self.encoder = _mlp([input_dim] + list(hidden_dims), generator)
        self.fc_mean = torch_linear(hidden_dims[-1], latent_dim, generator)
        self.fc_log_var = torch_linear(hidden_dims[-1], latent_dim, generator)

    def forward(self, x, *, masks=None, generator=None, train=False):
        h = _hidden(list(self.encoder.values()), x, masks, generator, train)
        return self.fc_mean(h), self.fc_log_var(h)


class Decoder(nn.Module):
    def __init__(self, latent_dim: int, hidden_dims: Optional[List[int]], output_dim: int,
                 generator: torch.Generator):
        super().__init__()
        hidden_dims = hidden_dims or [256, 512]
        self.decoder = _mlp([latent_dim] + list(hidden_dims), generator)
        self.decoder[str(3 * len(hidden_dims) - 1)] = torch_linear(hidden_dims[-1], output_dim,
                                                                   generator)

    def forward(self, z, *, masks=None, generator=None, train=False):
        *layers, out = self.decoder.values()
        return out(_hidden(layers, z, masks, generator, train))


class VAE(nn.Module):
    def __init__(
        self,
        input_dim: int = 1024,
        encoder_hidden: Optional[List[int]] = None,
        decoder_hidden: Optional[List[int]] = None,
        latent_dim: int = 128,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.encoder = Encoder(input_dim, encoder_hidden, latent_dim, generator)
        self.decoder = Decoder(latent_dim, decoder_hidden, input_dim, generator)
        self.latent_dim = latent_dim
        self.input_dim = input_dim

    def forward(self, x: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                train: bool = False, draws: Optional[Draws] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x_hat, mean, log_var).  z = mean + eps * exp(log_var / 2) with
        eps from ``draws["eps"]`` or drawn from ``generator``; z = mean
        without either.  Training applies dropout with the keep masks of
        ``draws["encoder"]`` / ``draws["decoder"]`` or drawn from
        ``generator``, in that order: encoder masks, eps, decoder masks."""
        draws = draws or {}
        mean, log_var = self.encoder(x, masks=draws.get("encoder"), generator=generator,
                                     train=train)
        eps = draws.get("eps")
        if eps is None and generator is not None:
            eps = torch.randn(mean.shape, generator=generator, device=generator.device)
        z = mean if eps is None else mean + eps.to(mean.device) * torch.exp(0.5 * log_var)
        x_hat = self.decoder(z, masks=draws.get("decoder"), generator=generator, train=train)
        return x_hat, mean, log_var

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic reconstruction from the mean latent (the
        reconstructed-feature writer's)."""
        return self(x)[0]


def kld_loss(mean: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """-(1/2) sum_j (1 + log var - mu^2 - var), mean over the batch
    (reference vae/loss.py:15-36)."""
    kld = -0.5 * torch.sum(1 + log_var - mean ** 2 - torch.exp(log_var), dim=1)
    return kld.mean()


def vae_loss(x, x_hat, mean, log_var):
    """(total, recon MSE, KLD), reference vae/loss.py:38-70."""
    recon = ((x_hat - x) ** 2).mean()
    reg = kld_loss(mean, log_var)
    return recon + reg, recon, reg

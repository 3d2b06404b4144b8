"""TMA feature extraction as ``extract_cores`` runs it, with the encoder
built by the port's ``vit_from_config`` over the configuration's ``model``
block (timm's keywords, so a ViT with a packed SwiGLU, register tokens or a
patch-only position embedding is built as the model card states it).
Streaming, check, control and the planted faults are ``extract_cores``'.

The warm-up builds every shape as ``extract_cores``' does, then streams
whole cycles for ``HEAT_SECONDS`` on a card: this encoder draws close to an H100's
700 W, so on a card held below its limit the clock follows the card's
heat, and each measured window has to start from the same load.

A program without ``vit_from_config`` cannot run this entry: its set-up
fails before it draws anything."""

from __future__ import annotations

import time

import torch

from portbench.entries import extract_cores
from portbench.entries.extract_cores import FAULTS, control  # noqa: F401 - the harness reads them
from portbench.harness import draw, manifest, traffic

HEAT_SECONDS = 12.0


class Entry(extract_cores.Entry):
    def __init__(self, cell, seed: int, device: torch.device, spans):
        from multimodal_fusion_tpu_torch.data import tma_extraction
        from multimodal_fusion_tpu_torch.models.vit import vit_from_config

        self.tma_extraction, self.spans, self.device = tma_extraction, spans, device
        self.config, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.reference = manifest.reference(cell.config["reference"])
        ext = self.ext = cell.config["extraction"]
        model = vit_from_config(
            cell.config["model"],
            torch.Generator(device=device).manual_seed(draw.derive(seed, "init")))
        model.load_state_dict(draw.weights(self.reference.weight_spec(cell.config), seed, device))
        self.extractor = tma_extraction.make_feature_extractor(
            model, int(ext["batch_size"]), compute_dtype=ext["compute_dtype"], device=device)
        self.images = traffic.cores(cell.traffic, seed, device)
        self.cycles = traffic.core_cycles(cell.traffic, seed)
        self.outputs = []  # (edge, pool index, features) of each core of the window
        self.failed = 0
        edges = sorted(self.images)
        self._extract([(e, 0) for e in dict.fromkeys((edges[0], edges[-1]))])  # the warm-up
        if device.type == "cuda":
            cycles = traffic.core_cycles(cell.traffic, seed)  # apart from the window's
            start = time.perf_counter()
            while time.perf_counter() - start < HEAT_SECONDS:
                self._extract(next(cycles))

"""Assigned input-shape set and allocation-free input specs (counterpart of
``repro/configs/shapes.py``).

Every LM arch is paired with the same four shapes:
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve prefill
  decode_32k   KV len 32,768, global_batch 128 -> serve_step (1 new token)
  long_500k    KV len 524,288, global_batch 1  -> serve_step; SUB-QUADRATIC
               archs only (xlstm, jamba) -- full-attention archs skip it

``input_specs`` returns tensors on the ``meta`` device, which carry shape
and dtype and allocate nothing (the reference's ``ShapeDtypeStruct``); the
[vlm]/[audio] stub frontends provide pre-computed bfloat16 embeddings
instead of token ids, and qwen2-vl's M-RoPE takes (B, S, 3) position
streams.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_inputs(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.frontend in ("vision_stub", "audio_stub"):
        # Precomputed patch/frame embeddings from the (stubbed) frontend.
        return _meta((batch, seq, cfg.d_model), torch.bfloat16)
    return _meta((batch, seq), torch.int32)


def _positions(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.pos_embedding == "mrope":
        return _meta((batch, seq, 3), torch.int32)
    return _meta((batch, seq), torch.int32)


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """``meta`` stand-ins for every model input of this cell."""
    spec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq_len
    if spec.mode == "train":
        return {
            "inputs": _token_inputs(cfg, b, s),
            "targets": _meta((b, s), torch.int32),
            "positions": _positions(cfg, b, s),
        }
    if spec.mode == "prefill":
        return {
            "inputs": _token_inputs(cfg, b, s),
            "positions": _positions(cfg, b, s),
        }
    # decode: one new token against a seq_len-deep cache
    return {
        "inputs": _token_inputs(cfg, b, 1),
        "positions": _positions(cfg, b, 1),
    }

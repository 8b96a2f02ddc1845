"""The score network in PyTorch (counterpart of ``sbgm_danra_tpu.models``)."""

from sbgm_danra_tpu_torch.models.attention import SpatialSelfAttention
from sbgm_danra_tpu_torch.models.embeddings import GaussianFourierEmbedding
from sbgm_danra_tpu_torch.models.unet import (
    Decoder,
    DecoderBlock,
    Encoder,
    ModelSpec,
    ScoreUNet,
    build_score_model,
)

__all__ = [
    "GaussianFourierEmbedding",
    "SpatialSelfAttention",
    "Encoder",
    "Decoder",
    "DecoderBlock",
    "ModelSpec",
    "ScoreUNet",
    "build_score_model",
]

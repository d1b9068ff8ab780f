"""Models of the port: the flagship GPT (LLaMA-style) LM, the encoder
family (BERT, ViT), the T5 encoder-decoder and the ResNet vision models,
with their configs, sampling and weights (counterpart of
ray_tpu/models; its ``t5_init_inputs`` shapes the JAX step's init call,
which the port's steps do not make)."""

from ray_tpu_torch.models.bert import BERT, masked_batch, mlm_loss_fn
from ray_tpu_torch.models.configs import PRESETS, TransformerConfig, get_config
from ray_tpu_torch.models.encoder import Encoder, EncoderBlock
from ray_tpu_torch.models.generate import Generator, generate, sample_logits
from ray_tpu_torch.models.gpt import GPT
from ray_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34, ResNet50,
                                         ResNet101)
from ray_tpu_torch.models.t5 import T5, greedy_decode, seq2seq_loss_fn
from ray_tpu_torch.models.vit import (VIT_PRESETS, ViT, ViTConfig,
                                      get_vit_config)

__all__ = ["GPT", "TransformerConfig", "PRESETS", "get_config",
           "Generator", "generate", "sample_logits",
           "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "BERT", "mlm_loss_fn", "masked_batch",
           "Encoder", "EncoderBlock",
           "T5", "seq2seq_loss_fn", "greedy_decode",
           "ViT", "ViTConfig", "VIT_PRESETS", "get_vit_config"]

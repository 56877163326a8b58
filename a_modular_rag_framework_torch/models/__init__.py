from .cross_encoder import CrossEncoderConfig, CrossEncoderReranker
from .encoder import EncoderConfig, TextEncoder
from .hash_embed import HashEmbedEncoder, device_embed, phrase_augment, tokenize
from .splade import SpladeConfig, SpladeEncoder

__all__ = ["CrossEncoderConfig", "CrossEncoderReranker", "EncoderConfig",
           "HashEmbedEncoder", "SpladeConfig", "SpladeEncoder", "TextEncoder",
           "device_embed", "phrase_augment", "tokenize"]

from .hash_embed import HashEmbedEncoder, device_embed, phrase_augment, tokenize

__all__ = ["HashEmbedEncoder", "device_embed", "phrase_augment", "tokenize"]

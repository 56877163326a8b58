from .graph_request_v2 import AssembleGraphRequestV2, Inputs, Sentence

__all__ = ["AssembleGraphRequestV2", "Inputs", "Sentence"]

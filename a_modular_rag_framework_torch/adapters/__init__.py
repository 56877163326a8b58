from .graph_request_adapter import hotpotqa_to_v2, normalize_title, upgrade_to_v2

__all__ = ["hotpotqa_to_v2", "normalize_title", "upgrade_to_v2"]

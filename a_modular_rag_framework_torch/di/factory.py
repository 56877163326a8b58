"""Settings-driven dependency-injection factory (port of
``a_modular_rag_framework_tpu/di/factory.py``).

The same functions with the same semantics:
  - ``import_from_string("pkg.mod:Class")`` dynamic import
  - ``${ENV_VAR}`` resolution in provider kwargs
  - three module-spec forms (string / {impl,kwargs} / {type,kwargs,impl,impl_kwargs})
  - reflection-filtered instantiation with router/sink auto-injection

What differs, and why:
  - ``load_settings`` reads a ``.json`` file with ``json`` (the port's own
    settings, ``config/settings_torch.json``) and needs PyYAML only for a
    ``.yaml`` / ``.yml`` path, imported inside the function;
  - the default module specs name the port's classes;
  - an optional top-level ``device`` key (``"cpu"``, ``"cuda:1"``) reaches
    every component that runs on a device: the embedding provider, the
    graph-construction module's semantic edges and the retrieval backend. Without it
    each of them asks for the card;
  - ``build_modules`` builds the retrieval agent first and hands its engine
    to the other agents, so one system holds one index on the device.
"""
from __future__ import annotations

import copy
import importlib
import inspect
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


def import_from_string(path: str):
    """Import ``"pkg.mod:Attr"`` (colon form) or ``"pkg.mod.Attr"`` (dotted)."""
    if ":" in path:
        mod_name, attr = path.split(":", 1)
    else:
        mod_name, attr = path.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr)


def load_settings(path: str) -> Dict[str, Any]:
    if Path(path).suffix.lower() in (".yaml", ".yml"):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"{path}: reading YAML settings needs PyYAML; give the "
                f"settings as a .json file instead") from e
        with open(path, "r", encoding="utf-8") as f:
            return yaml.safe_load(f) or {}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f) or {}


SHIPPED_SETTINGS = Path(__file__).resolve().parents[2] / "config" / "settings_torch.json"


def write_settings(path, *, base=SHIPPED_SETTINGS, device: Optional[str] = None,
                   dataset: Optional[Dict[str, Any]] = None, docs=None,
                   graph_root=None, root_dir=None,
                   index: Optional[Dict[str, Any]] = None,
                   retrieval: Optional[Dict[str, Any]] = None) -> str:
    """Write to ``path`` (JSON) the settings at ``base`` (the shipped
    config/settings_torch.json) pointed at a corpus: the ``dataset`` block,
    the backend's index_path (``docs``, a docs.jsonl whose packed cache lies
    beside it) and ``graph_root``, graph construction's ``root_dir``,
    ``index`` / ``retrieval`` updates of the index block and the backend's
    kwargs, and the top-level ``device`` (none: as ``base`` has it; the
    card when it names none). What is not given stays as ``base`` has it.
    Returns the path."""
    s = load_settings(str(base))
    if device:
        s["device"] = str(device)
    if dataset is not None:
        s["dataset"] = dataset
    if index:
        s.setdefault("index", {}).update(index)
    rk = s["modules"]["retrieval"].setdefault("impl_kwargs", {})
    if docs is not None:
        rk["index_path"] = str(docs)
    if graph_root is not None:
        rk["graph_root"] = str(graph_root)
    rk.update(retrieval or {})
    if root_dir is not None:
        s["modules"]["graph_construction"].setdefault(
            "impl_kwargs", {})["root_dir"] = str(root_dir)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(s, indent=1))
    return str(path)


def with_device(settings: Dict[str, Any]) -> Dict[str, Any]:
    """Settings with the top-level ``device`` key (when there is one) filled
    into graph construction's ``edge_builder`` kwargs, where its flow (a copy
    of the JAX package's) reads them; kwargs that name a device themselves
    win. The retrieval flow reads the key itself. Returns a copy, or
    ``settings`` itself when it has no ``device`` key."""
    device = settings.get("device")
    if not device:
        return settings
    out = copy.deepcopy(settings)
    gc = out.setdefault("modules", {}).setdefault("graph_construction", {})
    if isinstance(gc, dict):
        edge = gc.setdefault("impl_kwargs", {}).setdefault(
            "edge_builder", dict(gc.get("edge_builder") or {}))
        edge.setdefault("device", device)
    return out


def resolve_env(v: Any) -> Any:
    """Resolve ``"${ENV_VAR}"`` strings to environment values."""
    if isinstance(v, str) and v.startswith("${") and v.endswith("}"):
        return os.getenv(v[2:-1], "")
    return v


def filtered_kwargs(cls, kwargs: Dict[str, Any], *, inject: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Keep only kwargs the class constructor accepts; inject router/sink etc.
    if the constructor declares them (mirrors retrieval/flow.py:95-107)."""
    sig = inspect.signature(cls.__init__)
    params = sig.parameters
    accepts_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())
    valid = set(params.keys()) - {"self"}
    out = {k: v for k, v in kwargs.items() if accepts_var_kw or k in valid}
    for k, v in (inject or {}).items():
        if (k in valid or accepts_var_kw) and k not in out:
            out[k] = v
    return out


def build_providers(settings: Dict[str, Any]) -> Dict[str, Any]:
    providers_cfg = settings.get("providers", {}) or {}
    providers: Dict[str, Any] = {}
    for name, cfg in providers_cfg.items():
        if isinstance(cfg, str):
            type_spec, kwargs = cfg, {}
        elif isinstance(cfg, dict):
            type_spec = cfg.get("type")
            kwargs = dict(cfg.get("kwargs") or {})
        else:
            continue
        if not type_spec:
            continue
        kwargs = {k: resolve_env(v) for k, v in kwargs.items()}
        cls = import_from_string(type_spec)
        device = settings.get("device")
        providers[name] = cls(**filtered_kwargs(
            cls, kwargs, inject={"device": device} if device else None))
    return providers


def build_router(settings: Dict[str, Any], providers: Dict[str, Any], sink=None):
    from ..core.llm_router import LLMRouter

    policy = settings.get("llm_policy", {}) or {}
    return LLMRouter(providers=providers, policy=policy, sink=sink)


def parse_module_spec(
    modules_cfg: Dict[str, Any], key: str, default_spec: str
) -> Tuple[str, Dict[str, Any]]:
    """Parse a module spec in any of the three supported forms.

    Returns ``(flow_spec, flow_kwargs)`` where impl/impl_kwargs (if present)
    are folded into ``flow_kwargs`` for the flow class to instantiate.
    """
    raw = (modules_cfg or {}).get(key)

    if isinstance(raw, str):
        return raw, {}

    if isinstance(raw, dict):
        spec = raw.get("type") or raw.get("impl") or default_spec
        kwargs = dict(raw.get("kwargs") or {})
        impl_spec = raw.get("impl")
        if impl_spec:
            kwargs["impl"] = impl_spec
            kwargs["impl_kwargs"] = dict(raw.get("impl_kwargs") or {})
        return spec, kwargs

    return default_spec, {}


def _instantiate(spec: str, kwargs: Dict[str, Any], settings: Dict[str, Any], router, sink, engine=None):
    cls = import_from_string(spec)
    if hasattr(cls, "from_settings"):
        fs_kwargs = filtered_kwargs_callable(cls.from_settings, {"router": router, "sink": sink, "engine": engine})
        return cls.from_settings(settings, **fs_kwargs)
    return cls(**filtered_kwargs(cls, kwargs, inject={"router": router, "sink": sink, "engine": engine}))


def filtered_kwargs_callable(fn, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    sig = inspect.signature(fn)
    accepts_var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values())
    return {k: v for k, v in kwargs.items() if accepts_var_kw or k in sig.parameters}


_DEFAULT_SPECS = {
    "graph_construction": "a_modular_rag_framework_torch.modules.graph_construction.flow:GraphConstructionFlow",
    "retrieval": "a_modular_rag_framework_torch.modules.retrieval.flow:RetrievalAgentFlow",
    "reasoning": "a_modular_rag_framework_torch.modules.reasoning.flow:ReasoningAgentFlow",
    "verification": "a_modular_rag_framework_torch.modules.verification.flow:VerifierAgentFlow",
}


def build_modules(settings: Dict[str, Any], router, sink=None, engine=None):
    """Build the four agents and return a NodeContext."""
    settings = with_device(settings)
    modules_cfg = settings.get("modules", {}) or {}

    built = {}
    for key in ("retrieval", *_DEFAULT_SPECS):
        if key in built:
            continue
        spec, kwargs = parse_module_spec(modules_cfg, key, _DEFAULT_SPECS[key])
        built[key] = _instantiate(spec, kwargs, settings, router, sink, engine=engine)
        if engine is None:  # one index on the device per system
            engine = getattr(getattr(built[key], "backend", None), "engine", None)

    from ..orchestrator.nodes import NodeContext

    return NodeContext(
        graph_c=built["graph_construction"],
        retriever=built["retrieval"],
        reasoner=built["reasoning"],
        verifier=built["verification"],
        sink=sink,
    )


def build_dataset_loader_from_settings(settings: Dict[str, Any]):
    from ..core.dataset_loader import build_dataset_loader

    cfg = settings.get("dataset", {}) or {}
    return build_dataset_loader(cfg) if cfg else None

"""ctypes bindings for the native host-path runtime (csrc/text_native.cpp).

The port's copy of ``a_modular_rag_framework_tpu/native/binding.py`` and of
its C++ source. The library is compiled on first use (g++ -O3 -shared) into
``csrc/build/`` under a content hash, written to a temporary name and
renamed into place, so a concurrent loader never sees a half-written file;
every entry point has a pure-Python fallback so the framework works without
a toolchain. The native paths cover:

  - `featurize_batch_native`: hash featurization for the encoder host stage;
  - `token_counts_native`: doc lengths;
  - `bm25_build_native`: streaming corpus -> CSR postings with precomputed,
    contribution-sorted BM25 scores (the index-build hot loop).

Bit-exact with the Python implementations (same crc32, same tokenizer, same
BM25 math) — asserted by tests/test_native.py for the original and
tests/test_torch_host_copies.py for this copy.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "text_native.cpp"
_BUILD = _SRC.parent / "build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib() -> Optional[Path]:
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    out = _BUILD / f"text_native_{digest}.so"
    if out.exists():
        return out
    tmp = _BUILD / f".text_native_{digest}.{os.getpid()}.so"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(_SRC), "-o", str(tmp), "-lz"]
    try:
        _BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native build failed (%r); using python fallback", e)
        tmp.unlink(missing_ok=True)
        return None


def load_native() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build_lib()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            logger.warning("native load failed: %r", e)
            return None

        c_char_pp = ctypes.POINTER(ctypes.c_char_p)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)

        lib.featurize_batch.argtypes = [c_char_pp, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, i32p, f32p]
        lib.token_counts.argtypes = [c_char_pp, ctypes.c_int, i32p]
        lib.bm25_create.restype = ctypes.c_void_p
        lib.bm25_destroy.argtypes = [ctypes.c_void_p]
        lib.bm25_add_docs.argtypes = [ctypes.c_void_p, c_char_pp, ctypes.c_int]
        lib.bm25_finalize.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_float]
        lib.bm25_finalize.restype = ctypes.c_int64
        for name in ("bm25_vocab_size", "bm25_vocab_blob_size", "bm25_n_docs"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int64
        lib.bm25_export.argtypes = [ctypes.c_void_p, i32p, f32p, f32p, i32p,
                                    f32p, f32p, ctypes.c_char_p]
        lib.vocab_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.vocab_create.restype = ctypes.c_void_p
        lib.vocab_destroy.argtypes = [ctypes.c_void_p]
        lib.vocab_lookup_batch.argtypes = [ctypes.c_void_p, c_char_pp,
                                           ctypes.c_int, ctypes.c_int, i32p]
        lib.hash_embed_batch.argtypes = [c_char_pp, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, f32p]
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.simple_scan.argtypes = [c_char_pp, ctypes.c_int, i8p]
        lib.encoder_tokens.argtypes = [c_char_pp, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, i32p, f32p]
        lib.bm25_add_docs_phrase.argtypes = [ctypes.c_void_p, c_char_pp,
                                             ctypes.c_int, i8p, c_char_pp]
        lib.entity_graph_build.argtypes = [c_char_pp, ctypes.c_int, i8p,
                                           c_char_pp, ctypes.c_int,
                                           ctypes.c_int, i32p]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return load_native() is not None


def _text_array(texts: List[str]):
    arr = (ctypes.c_char_p * len(texts))()
    # Pre-lowercase with Python's full Unicode tables: the C++ tokenizer
    # lowercases ASCII bytes only, and some non-ASCII chars lower() into
    # ASCII letters (e.g. Kelvin sign -> 'k'). Feeding it pre-lowercased
    # utf-8 keeps native and Python token streams bit-identical.
    encoded = [t.lower().encode("utf-8", errors="ignore") for t in texts]
    for i, e in enumerate(encoded):
        arr[i] = e
    return arr, encoded  # keep `encoded` alive


def _text_array_raw(texts: List[str]):
    """char** over RAW (capitalization-preserving) utf-8 — for the native
    stages that extract capitalized runs themselves. Only pure-ASCII rows
    are processed natively (simple_scan gates the rest to Python), so the
    ASCII-only lower()/isupper() in C++ is exact where it runs."""
    arr = (ctypes.c_char_p * len(texts))()
    encoded = [(t or "").encode("utf-8", errors="ignore") for t in texts]
    for i, e in enumerate(encoded):
        arr[i] = e
    return arr, encoded


def _simple_status(lib, arr, n) -> np.ndarray:
    status = np.zeros(n, dtype=np.int8)
    lib.simple_scan(arr, n,
                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return status


def featurize_batch_native(
    texts: List[str], dim: int, max_features: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = load_native()
    if lib is None or not texts:
        return None
    n = len(texts)
    buckets = np.zeros((n, max_features), dtype=np.int32)
    signs = np.zeros((n, max_features), dtype=np.float32)
    arr, keep = _text_array(texts)
    lib.featurize_batch(
        arr, n, dim, max_features,
        buckets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        signs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return buckets, signs


def hash_embed_batch_native(
    texts: List[str], dim: int, max_features: int
) -> Optional[np.ndarray]:
    """Fused featurize + signed-bucket accumulate + L2 normalize: the whole
    hash-embed host stage in one C call ([B, dim] f32). Numerically equal
    to encode_token_batch(featurize(texts)) up to float summation order
    (signs are +-1, so sums are exact small integers; only the norm's
    rounding can differ in the last ulp)."""
    lib = load_native()
    if lib is None or not texts:
        return None
    n = len(texts)
    out = np.zeros((n, dim), dtype=np.float32)
    arr, keep = _text_array(texts)
    lib.hash_embed_batch(arr, n, dim, max_features,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def encoder_tokens_native(
    texts: List[str], max_len: int, vocab: int, ngrams: int,
    ngram_min: int, ngram_max: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """TextEncoder featurization (models/encoder.encode_tokens) in one C
    call: -> (ids int32 [n, L] or [n, L, G], mask f32 [n, L]). Bit-exact
    with the Python path (same crc32, same tokenizer, same cyclic fill)."""
    lib = load_native()
    if lib is None or not texts:
        return None
    n, G = len(texts), max(1, int(ngrams))
    ids = np.zeros((n, max_len, G), dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=np.float32)
    arr, keep = _text_array(texts)
    lib.encoder_tokens(arr, n, max_len, vocab, G, ngram_min, ngram_max,
                       ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if ngrams <= 1:
        ids = ids.reshape(n, max_len)
    return ids, mask


def token_counts_native(texts: List[str]) -> Optional[np.ndarray]:
    lib = load_native()
    if lib is None:
        return None
    n = len(texts)
    counts = np.zeros(n, dtype=np.int32)
    arr, keep = _text_array(texts)
    lib.token_counts(arr, n, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return counts


class NativeVocab:
    """Native hash-map vocab for batched query term-id lookup."""

    def __init__(self, vocab: Dict[str, int]):
        self._lib = load_native()
        self._handle = None
        if self._lib is None:
            return
        # term order must follow ids: blob line k = term with id k
        terms = sorted(vocab, key=vocab.__getitem__)
        blob = ("\n".join(terms) + "\n").encode("utf-8") if terms else b""
        self._blob = blob  # keep alive
        self._handle = self._lib.vocab_create(blob, len(blob))

    @property
    def available(self) -> bool:
        return self._handle is not None

    def lookup_batch(self, texts: List[str], max_terms: int) -> Optional[np.ndarray]:
        if self._handle is None:
            return None
        n = len(texts)
        out = np.empty((n, max_terms), dtype=np.int32)
        arr, keep = _text_array(texts)
        self._lib.vocab_lookup_batch(
            self._handle, arr, n, max_terms,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            try:
                self._lib.vocab_destroy(self._handle)
            except Exception:
                pass


def bm25_build_native(
    texts: List[str], k1: float = 1.5, b: float = 0.75, chunk: int = 65536,
    phrase_tokens: bool = False,
) -> Optional[Dict[str, object]]:
    """Streaming native BM25 build; returns the Bm25DeviceIndex field dict.

    With ``phrase_tokens=True`` the phrase pseudo-tokens (phrase_augment)
    are appended in the C++ tokenize loop for simple (pure-ASCII) rows —
    removing the Python per-text augmentation pre-pass from the build
    path; non-simple rows are augmented by Python and fed verbatim."""
    lib = load_native()
    if lib is None:
        return None
    h = lib.bm25_create()
    try:
        for i in range(0, len(texts), chunk):
            part = texts[i : i + chunk]
            if phrase_tokens:
                arr, keep = _text_array_raw(part)
                status = _simple_status(lib, arr, len(part))
                repl = (ctypes.c_char_p * len(part))()
                keep_repl = []
                if status.any():
                    from ..models.hash_embed import phrase_augment
                    for j in np.nonzero(status)[0]:
                        e = phrase_augment(part[int(j)]).lower().encode(
                            "utf-8", errors="ignore")
                        keep_repl.append(e)
                        repl[int(j)] = e
                lib.bm25_add_docs_phrase(
                    h, arr, len(part),
                    status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    repl)
                continue
            arr, keep = _text_array(part)
            lib.bm25_add_docs(h, arr, len(part))
        total = int(lib.bm25_finalize(h, k1, b))
        V = int(lib.bm25_vocab_size(h))
        n_docs = int(lib.bm25_n_docs(h))
        blob_size = int(lib.bm25_vocab_blob_size(h))

        doc_ids = np.zeros(total, dtype=np.int32)
        tfs = np.zeros(total, dtype=np.float32)
        scores = np.zeros(total, dtype=np.float32)
        row_ptr = np.zeros(V + 1, dtype=np.int32)
        df = np.zeros(V, dtype=np.float32)
        doc_lens = np.zeros(n_docs, dtype=np.float32)
        blob = ctypes.create_string_buffer(blob_size)
        lib.bm25_export(
            h,
            doc_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            df.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            doc_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            blob,
        )
        terms = blob.raw[:blob_size].decode("utf-8").splitlines()
        vocab = {t: i for i, t in enumerate(terms)}
        return {"doc_ids": doc_ids, "tfs": tfs, "scores": scores,
                "row_ptr": row_ptr, "df": df, "doc_lens": doc_lens,
                "vocab": vocab}
    finally:
        lib.bm25_destroy(h)


class NativeBridge:
    """Native hop-2 bridge-extraction stage (iterative multi-hop mode).

    Registers the corpus once (texts + titles, raw capitalization); each
    batch call returns per-query '\\n'-joined hop-2 variants, or None for
    queries the native path cannot serve bit-exactly (non-ASCII or
    quote/hyphen texts — Python's Unicode-aware path handles those).
    Semantics parity with modules/retrieval/multihop.py is asserted by
    tests/test_native.py.
    """

    def __init__(self, docs: List[dict], question_words) -> None:
        self._lib = load_native()
        self._handle = None
        if self._lib is None:
            return
        lib = self._lib
        if not hasattr(lib, "_bridge_bound"):
            lib.bridge_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.bridge_create.restype = ctypes.c_void_p
            lib.bridge_destroy.argtypes = [ctypes.c_void_p]
            c_char_pp = ctypes.POINTER(ctypes.c_char_p)
            lib.bridge_add_docs.argtypes = [ctypes.c_void_p, c_char_pp,
                                            c_char_pp, ctypes.c_int]
            lib.bridge_hop2_batch.argtypes = [
                ctypes.c_void_p, c_char_pp, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_char_p, ctypes.c_int64]
            lib._bridge_bound = True
        blob = ("\n".join(sorted(question_words)) + "\n").encode("utf-8")
        self._handle = lib.bridge_create(blob, len(blob))
        chunk = 65536
        for i in range(0, len(docs), chunk):
            part = docs[i:i + chunk]
            texts = (ctypes.c_char_p * len(part))()
            titles = (ctypes.c_char_p * len(part))()
            keep = []
            for j, d in enumerate(part):
                t = (d.get("text") or "").encode("utf-8", errors="ignore")
                ti = (d.get("title") or "").encode("utf-8", errors="ignore")
                keep.append((t, ti))
                texts[j] = t
                titles[j] = ti
            lib.bridge_add_docs(self._handle, texts, titles, len(part))

    @property
    def available(self) -> bool:
        return self._handle is not None

    def hop2_batch(self, queries: List[str], ids: np.ndarray,
                   max_entities: int = 4, max_variants: int = 3,
                   stride: int = 1024,
                   high_df_blob: Optional[bytes] = None,
                   ) -> Optional[List[Optional[List[str]]]]:
        """-> per-query variant list ([] = inactive, None = use Python
        fallback), or None when the native library is unavailable.

        ``high_df_blob`` ('\\n'-joined lowercase terms) makes the native
        stage emit each variant already pruned (engine prune_query
        semantics), so the caller can dispatch with prepruned=True."""
        if self._handle is None:
            return None
        B = len(queries)
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        K = ids.shape[1] if ids.ndim == 2 else 0
        arr = (ctypes.c_char_p * B)()
        keep = [q.encode("utf-8", errors="ignore") for q in queries]
        for i, e in enumerate(keep):
            arr[i] = e
        out = ctypes.create_string_buffer(B * stride)
        status = np.zeros(B, dtype=np.int8)
        self._lib.bridge_hop2_batch(
            self._handle, arr, B,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), K,
            max_entities, max_variants, out, stride,
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            high_df_blob, len(high_df_blob) if high_df_blob else 0)
        results: List[Optional[List[str]]] = []
        raw = out.raw
        for b in range(B):
            if status[b]:
                results.append(None)
                continue
            row = raw[b * stride:(b + 1) * stride]
            s = row.split(b"\0", 1)[0].decode("utf-8", errors="ignore")
            results.append(s.split("\n") if s else [])
        return results

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            try:
                self._lib.bridge_destroy(self._handle)
            except Exception:
                pass


def entity_graph_native(
    texts: List[str], max_degree: int = 32, entity_chain_cap: int = 64,
) -> Optional[np.ndarray]:
    """Entity-link adjacency table [n, max_degree] int32 (-1 pad) — the
    native counterpart of index/builder.py's entity channel. Rows failing
    the simple-text gate get their entities extracted by Python
    (utils.entity_linker.simple_ner) and passed through; everything else
    (run extraction, ordered dedup, chain caps, hub+chain insertion with
    capped dedup) runs in one C++ pass. Bit-exact with the Python builder
    (tests/test_native.py)."""
    lib = load_native()
    if lib is None:
        return None
    n = len(texts)
    arr, keep = _text_array_raw(texts)
    status = _simple_status(lib, arr, n)
    repl = (ctypes.c_char_p * n)()
    keep_repl = []
    if status.any():
        from ..utils.entity_linker import simple_ner
        for j in np.nonzero(status)[0]:
            e = "\n".join(simple_ner(texts[int(j)] or "")).encode(
                "utf-8", errors="ignore")
            keep_repl.append(e)
            repl[int(j)] = e
    out = np.full((n, max_degree), -1, dtype=np.int32)
    lib.entity_graph_build(
        arr, n, status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        repl, max_degree, entity_chain_cap,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out

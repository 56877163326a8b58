"""The hash embedding of packed bytes (`ops.hash_embed`, `csrc/hash_embed.cu`)
and the dense path's seam to it.

On the CPU: the host packing (`models.hash_embed.pack_texts`), the plain
version of the kernel's algorithm held bit for bit to the function it
reproduces (the JAX package's `HashEmbedEncoder.encode_texts`), to the
port's native host path (`hash_embed_batch_native`) and to
`hash_embed_numpy`, a model of the kernel's table-driven crc32, the
wrapper's checks, the engines' choice of the seam and its ranges. On the
card (`gpu` marker): the kernel against the same references bit for bit,
and `query_dense_batch`, the hybrid path and `ShardedDenseEngine` through
it.
"""
import json
import sys
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from a_modular_rag_framework_torch._host import to_device
from a_modular_rag_framework_torch.core.dataset_loader import \
    SyntheticHotpotQALoader
from a_modular_rag_framework_torch.engine import (EngineConfig,
                                                  TorchQueryEngine)
from a_modular_rag_framework_torch.index import (SentenceCorpus,
                                                 build_packed_index)
from a_modular_rag_framework_torch.models.hash_embed import (
    HashEmbedEncoder, hash_embed_numpy, pack_texts)
from a_modular_rag_framework_torch.native import binding
from a_modular_rag_framework_torch.ops import hash_embed as ops_hash
from a_modular_rag_framework_torch.ops.topk import dense_topk
from a_modular_rag_framework_torch.parallel import (ShardedDenseEngine,
                                                    build_mesh)
from a_modular_rag_framework_torch.telemetry.stages import (
    reset_stage_table, stage_table)
from a_modular_rag_framework_tpu.models.hash_embed import \
    HashEmbedEncoder as JaxHashEmbedEncoder

REPO = Path(__file__).resolve().parents[1]
KELVIN = "\N{KELVIN SIGN}"  # lowers into the ASCII letter k


def _random_rows(seed, n, alphabet, max_len):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(alphabet), size=int(rng.integers(
        0, max_len + 1)))) for _ in range(n)]


def _words(n, stem="w"):
    return " ".join(f"{stem}{i}" for i in range(n))


# name -> (texts, whether `hash_embed_numpy` computes the same function on
# them: it neither cuts a row at a NUL nor the features at max_features)
CASES = {
    "empty": (["", "", "a", ""], True),
    "punctuation": (["...", "!!a--b??", "  ,;: ", "a.b.c...d", "_a_b_"],
                    True),
    "digits": (["123 456", "route 66 to 2024", "0", "a1b2 c3 007"], True),
    "mixed_case": (["Hello WORLD", "MiXeD CaSe tOkEnS", "ABC abc AbC"],
                   True),
    "chunk_edges": (["a" * 31 + " " + "b" * 40, "x" * 100, " " * 31 + "q",
                     "ab " * 40, "z" * 32 + "." + "y" * 32], True),
    "random_ascii": (_random_rows(7, 64, "aZ9 .,-_!\t", 200), True),
    "non_ascii": ([KELVIN, KELVIN + "elvin scale", "Stra\u00dfe",
                   "\u0130stanbul", "na\u00efve caf\u00e9",
                   "\u65e5\u672c\u8a9e text", "\u03a9mega " + KELVIN + "9",
                   "plain ascii row"], True),
    "over_max_features": ([_words(300), _words(200), " ".join(["x"] * 256),
                           _words(255), _words(128), _words(129),
                           _words(130), "short row"], False),
    "nul": (["abc\0def", "\0abc", "ab\0", "a b\0 c d", KELVIN + "\0x y",
             "no nul here"], False),
}


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _assert_reproduces(got, texts, dim=64, max_features=256):
    """``got`` equals, bit for bit, the rows of the function the port
    reproduces (the JAX package's ``encode_texts``) and of the port's
    native host path."""
    got = _bits(got)
    np.testing.assert_array_equal(got, _bits(JaxHashEmbedEncoder(
        dim, max_features).encode_texts(texts)))
    native = binding.hash_embed_batch_native(texts, dim, max_features)
    assert native is not None
    np.testing.assert_array_equal(got, _bits(native))


def _packed(texts, device="cpu"):
    data, offsets = pack_texts(texts)
    return (to_device(data, device, non_blocking=True),
            to_device(offsets, device, non_blocking=True))


@pytest.fixture(scope="module")
def generated_questions():
    """4,096 questions from the benchmark's HotpotQA-width generator."""
    sys.path.insert(0, str(REPO / "benchmark" / "corpora"))
    try:
        import hotpot_distractor
    finally:
        sys.path.remove(str(REPO / "benchmark" / "corpora"))
    cfg = json.loads((REPO / "benchmark" / "configs" / "hotpot1m-hash.json")
                     .read_text(encoding="utf-8"))
    samples = hotpot_distractor.generate_chunk(
        (cfg["corpus"], 4096, 2**32 + 977, 0, 4096))
    return [s["question"] for s in samples]


# ---------------- on the CPU ----------------


def _stage_counts(fn):
    reset_stage_table()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
        return out, {name: n for name, (n, _) in stage_table().items()}
    finally:
        reset_stage_table()


@pytest.mark.parametrize("dim,max_features", [(64, 256), (13, 256),
                                              (64, 8)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_equals_the_native_host_path(case, dim, max_features):
    texts, same_as_numpy = CASES[case]
    enc = HashEmbedEncoder(dim=dim, max_features=max_features)
    got = enc.device_encode(*_packed(texts)).numpy()
    assert got.shape == (len(texts), dim)
    _assert_reproduces(got, texts, dim, max_features)
    if same_as_numpy and max_features == 256:
        np.testing.assert_array_equal(_bits(got),
                                      _bits(hash_embed_numpy(texts, dim)))


def test_plain_version_on_generated_questions(generated_questions):
    qs = generated_questions
    got = HashEmbedEncoder().device_encode(*_packed(qs)).numpy()
    _assert_reproduces(got, qs)
    np.testing.assert_array_equal(_bits(got), _bits(hash_embed_numpy(qs)))


def _kernel_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = 0xEDB88320 ^ (c >> 1) if c & 1 else c >> 1
        table.append(c)
    return table


def _register(table, s, data):
    for c in data:
        s = table[(s ^ c) & 0xFF] ^ (s >> 8)
    return s


@pytest.mark.parametrize("a,b", [(b"a", b"b"), (b"ananan00belanan", b"x9"),
                                 (b"2024", b"k"), (b"q" * 40, b"r" * 33)])
def test_kernel_crc_chains_a_bigram_through_the_register(a, b):
    """The kernel's crc32: its table and register, the final complement,
    and a bigram fed '_' and its second token from the first token's
    register."""
    table = _kernel_table()
    reg_a = _register(table, 0xFFFFFFFF, a)
    assert reg_a ^ 0xFFFFFFFF == zlib.crc32(a)
    bigram = _register(table, reg_a, b"_" + b) ^ 0xFFFFFFFF
    assert bigram == zlib.crc32(a + b"_" + b)
    assert bigram == zlib.crc32(b, zlib.crc32(b"_", zlib.crc32(a)))


def _rows(data, offsets):
    raw = data.tobytes()
    return [raw[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]


def _separated(rows):
    return [r + b"\0" for r in rows[:-1]] + rows[-1:]


@pytest.mark.parametrize("extra", [[], ["a\0b", "\0"]])
def test_packing_gives_the_native_paths_bytes(extra):
    """An ASCII batch is packed raw (the kernel lowers ASCII): each row is
    `_text_array`'s bytes but for case, then the NUL separator; rows that
    hold NULs of their own do not move the offsets. A batch with a
    non-ASCII row is packed row by row: each row is `_text_array`'s bytes
    exactly, then the separator."""
    ascii_rows = (CASES["mixed_case"][0] + extra + CASES["random_ascii"][0]
                  + [""])
    _, encoded = binding._text_array(ascii_rows)
    data, offsets = pack_texts(ascii_rows)
    assert data.dtype == np.uint8 and offsets.dtype == np.int32
    assert offsets[0] == 0 and offsets[-1] == data.size
    rows = _rows(data, offsets)
    assert rows == _separated([t.encode("ascii") for t in ascii_rows])
    assert [r.lower() for r in rows] == _separated(encoded)
    mixed = ascii_rows + [KELVIN + "elvin"]
    _, encoded = binding._text_array(mixed)
    assert _rows(*pack_texts(mixed)) == _separated(encoded)


@pytest.mark.parametrize("texts,data,offsets", [
    ([], b"", [0]), ([""], b"", [0, 0]), (["only row"], b"only row", [0, 8]),
    (["", ""], b"\0", [0, 1, 1]), (["ab", "c"], b"ab\0c", [0, 3, 4])])
def test_packing_of_small_batches(texts, data, offsets):
    got_data, got_offsets = pack_texts(texts)
    assert got_data.tobytes() == data and got_offsets.tolist() == offsets


@pytest.mark.parametrize("texts,lowered", [(["Ascii only", ""], 0),
                                           (["Ascii", KELVIN], 1)])
def test_packing_opens_the_lower_range_only_for_non_ascii_batches(
        texts, lowered):
    _, counts = _stage_counts(lambda: pack_texts(texts))
    assert counts.get("engine/featurize/lower", 0) == lowered


def test_dispatch_on_cpu_takes_the_plain_version_and_counts_no_launch():
    before = ops_hash.hash_embed_cuda.launches
    data, offsets = _packed(["a b", "c"])
    out = ops_hash.hash_embed(data, offsets, 64, 256)
    assert out.dtype == torch.float32 and out.shape == (2, 64)
    assert ops_hash.hash_embed_cuda.launches == before


def test_cuda_wrapper_raises_on_cpu_tensors():
    data, offsets = _packed(["a b"])
    with pytest.raises(ValueError, match="CUDA"):
        ops_hash.hash_embed_cuda(data, offsets, 64, 256)


def test_the_kernel_launches_through_an_operator_with_no_cpu_kernel():
    op = torch.ops.amrf.hash_embed_launch
    assert [a.name for a in op.default._schema.arguments] == [
        "data", "offsets", "dim", "max_features"]
    data, offsets = _packed(["a b"])
    with pytest.raises(NotImplementedError):
        op(data, offsets, 64, 256)


@pytest.fixture(scope="module")
def corpus():
    samples = SyntheticHotpotQALoader(
        {"count": 8, "seed": 5, "unique_entities": True,
         "n_distractors": 1}).load()
    idx = build_packed_index(SentenceCorpus.from_hotpotqa(samples),
                             embed_dim=32, embed_dtype="float32")
    return [s["question"] for s in samples], idx


class _LearnedLike:
    """An encoder with no ``device_encode`` (as `TextEncoder`)."""
    device = None


@pytest.mark.parametrize("device,encoder,on_card", [
    ("cuda", HashEmbedEncoder(), True), ("cuda:1", HashEmbedEncoder(), True),
    ("cpu", HashEmbedEncoder(), False), ("cuda", _LearnedLike(), False),
    ("cpu", _LearnedLike(), False)])
def test_queries_are_hashed_on_the_card_by_device_and_encoder(
        device, encoder, on_card):
    """The seam is chosen from what the engine observes: its device's type
    and whether its encoder has ``device_encode``."""
    eng = SimpleNamespace(device=torch.device(device), encoder=encoder)
    assert TorchQueryEngine._hash_on_device.fget(eng) is on_card


def test_the_packed_seam_gives_the_host_paths_rows(corpus, monkeypatch):
    """The seam a CUDA engine takes (here on the CPU, through the plain
    version) packs in ``engine/featurize`` and encodes in
    ``engine/hash_embed`` inside ``engine/embed``, and its rows are the
    host path's; a CPU engine's dense path keeps the host path."""
    questions, idx = corpus
    eng = TorchQueryEngine(idx, device="cpu", config=EngineConfig(top_k=5))
    _, counts = _stage_counts(lambda: eng.query_dense_batch(questions))
    assert "engine/hash_embed" not in counts
    assert counts["engine/featurize"] == 1
    host = eng._embed_queries(questions, fused=False, pad_to=16)
    monkeypatch.setattr(TorchQueryEngine, "_hash_on_device", True)
    packed, counts = _stage_counts(lambda: eng._embed_queries(
        questions, fused=False, pad_to=16))
    assert counts == {"engine/featurize": 1, "engine/embed": 1,
                      "engine/hash_embed": 1}
    np.testing.assert_array_equal(_bits(packed.numpy()),
                                  _bits(host.numpy()))


def test_the_hybrid_path_takes_the_packed_seam_too(corpus, monkeypatch):
    """`query_batch` (the hybrid path's host prep) hashes through the same
    seam as the dense path when the engine hashes on the card."""
    questions, idx = corpus
    eng = TorchQueryEngine(idx, device="cpu", config=EngineConfig(top_k=5))
    monkeypatch.setattr(TorchQueryEngine, "_hash_on_device", True)
    res, counts = _stage_counts(lambda: eng.query_batch(questions))
    assert counts["engine/host_prep"] == counts["engine/hash_embed"] == 1
    assert res.hits.ids.shape == (len(questions), 5)


# ---------------- on the card ----------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dim,max_features", [(64, 256), (13, 256), (64, 8),
                                              (1, 1), (1024, 256),
                                              (64, 2000)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_equals_the_native_host_path(cuda_device, case, dim,
                                                 max_features):
    texts, _ = CASES[case]
    before = ops_hash.hash_embed_cuda.launches
    out = HashEmbedEncoder(dim=dim, max_features=max_features).device_encode(
        *_packed(texts, cuda_device))
    assert out.device == cuda_device and out.shape == (len(texts), dim)
    assert ops_hash.hash_embed_cuda.launches == before + 1
    _assert_reproduces(out.cpu().numpy(), texts, dim, max_features)


@pytest.mark.gpu
def test_cuda_kernel_on_generated_questions(cuda_device,
                                            generated_questions):
    qs = generated_questions
    out = HashEmbedEncoder().device_encode(*_packed(qs, cuda_device))
    _assert_reproduces(out.cpu().numpy(), qs)


@pytest.mark.gpu
def test_cuda_kernel_raises_where_one_row_does_not_fit(cuda_device):
    """dim + 3 * max_features above 12,032 words: one row's shared memory
    would exceed the 48 KB a block gets."""
    data, offsets = _packed(["a b"], cuda_device)
    assert HashEmbedEncoder(dim=32, max_features=4000).device_encode(
        data, offsets).shape == (1, 32)
    with pytest.raises(RuntimeError, match="launch failed"):
        HashEmbedEncoder(dim=64, max_features=4000).device_encode(data,
                                                                  offsets)


@pytest.mark.gpu
def test_cuda_kernel_takes_an_all_empty_batch(cuda_device):
    out = HashEmbedEncoder().device_encode(*_packed(["", ""], cuda_device))
    assert out.shape == (2, 64) and not out.any()


@pytest.mark.gpu
def test_dense_batch_through_the_kernel_equals_the_host_path(
        cuda_device, corpus):
    questions, idx = corpus
    questions = questions + [KELVIN + "elvin " + questions[0]]
    eng = TorchQueryEngine(idx, device=cuda_device,
                           config=EngineConfig(top_k=5))
    before = ops_hash.hash_embed_cuda.launches
    res = eng.query_dense_batch(questions)
    assert ops_hash.hash_embed_cuda.launches == before + 1
    B = eng._bucket(len(questions))
    padded = questions + [""] * (B - len(questions))
    q = to_device(eng.encoder.encode_texts(padded), cuda_device)
    s, i = dense_topk(q, eng._emb, 5)
    np.testing.assert_array_equal(res.hits.ids,
                                  i[:len(questions)].cpu().numpy())
    np.testing.assert_array_equal(_bits(res.hits.scores),
                                  _bits(s[:len(questions)].cpu().numpy()))


@pytest.mark.gpu
def test_stage_table_counts_one_hash_embed_per_dense_call(cuda_device,
                                                          corpus):
    questions, idx = corpus
    eng = TorchQueryEngine(idx, device=cuda_device,
                           config=EngineConfig(top_k=5))
    eng.query_dense_batch(questions)  # builds the kernels

    def calls():
        eng.query_dense_batch(questions)
        eng.query_dense_batch(questions)
        eng.query_dense_batch(questions[:-1] + [KELVIN + questions[-1]])

    _, counts = _stage_counts(calls)
    assert counts["engine/featurize"] == counts["engine/hash_embed"] == 3
    assert counts["engine/featurize/lower"] == 1


@pytest.mark.gpu
def test_hybrid_and_sharded_dense_paths_hash_through_the_kernel(
        cuda_device, corpus):
    """`query_batch` and `ShardedDenseEngine` on the card launch the kernel
    once a batch; the sharded engine's query rows are the host path's."""
    questions, idx = corpus
    eng = TorchQueryEngine(idx, device=cuda_device,
                           config=EngineConfig(top_k=5))
    before = ops_hash.hash_embed_cuda.launches
    eng.query_batch(questions)
    assert ops_hash.hash_embed_cuda.launches == before + 1
    sharded = ShardedDenseEngine(idx, mesh=build_mesh(
        {"data": 2}, devices=[cuda_device] * 2))
    q = sharded.embed_queries(questions)
    assert ops_hash.hash_embed_cuda.launches == before + 2
    assert q.device == cuda_device and q.is_contiguous()
    _assert_reproduces(q.cpu().numpy(), questions, idx.embed_dim)
    hits = sharded.query_batch(questions, top_k=5)
    assert hits.ids.shape == (len(questions), 5)

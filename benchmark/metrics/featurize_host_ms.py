"""Host ms per ``engine/featurize`` range of the program (one per
`query_dense_batch` call: the batch's padding and the encoder's host
call from text to arrays; on the card the hash encoder's byte packing,
``pack_texts``, whose rows the hash kernel makes in ``engine/embed``),
mean over the traced window. Read from the program's stage table
(``telemetry.stages``), which sums each range's host-clock time while a
profiler records: in a ``--trace 1`` run, the window alone."""


def read(run):
    if not run.trace:
        return None
    try:
        from a_modular_rag_framework_torch.telemetry.stages import \
            stage_table
    except ImportError:  # a program without the stage table
        return None
    count, seconds = stage_table().get("engine/featurize", (0, 0.0))
    return 1e3 * seconds / count if count else None

"""Host ms per ``engine/fetch`` range of the program (one per
`query_dense_batch` call: the wait for the device and the copies of the
scores and ids to the host), mean over the traced window. Read from the
program's stage table (``telemetry.stages``), which sums each range's
host-clock time while a profiler records: in a ``--trace 1`` run, the
window alone."""


def read(run):
    if not run.trace:
        return None
    try:
        from a_modular_rag_framework_torch.telemetry.stages import \
            stage_table
    except ImportError:  # a program without the stage table
        return None
    count, seconds = stage_table().get("engine/fetch", (0, 0.0))
    return 1e3 * seconds / count if count else None

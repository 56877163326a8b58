"""Host ms per ``query_batch_async`` call of the pipelined hybrid loop
(the benchmark's ``bench/host_enqueue`` span: host prep, uploads and the
program's launches), mean over the traced window."""


def read(run):
    s = run.spans.get("host_enqueue")
    return 1e3 * sum(s) / len(s) if s else None

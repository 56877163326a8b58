"""The single-pass hybrid answers against the plain reference's hybrid
semantics (`harness.check.check_hybrid`): ``hybrid_rank_gap`` and
``hybrid_score_err`` over the sampled answers. Control: the reference
with every score rounded to bfloat16, in the program's place."""
from harness import check


def make(ctx):
    # postings only for the terms of the questions to be judged
    asked = set()
    for call, row in ctx.sample:
        q = ctx.questions[int(ctx.results[call][0][row])]
        asked.update(ctx.ref.tokenize(q))
        asked.update(ctx.ref.phrase_tokens(q))
    ref = ctx.ref.HotpotReference(ctx.samples, ctx.config,
                                  posting_terms=asked)
    ctx.row_of = ref.row_of

    def judge(control=None):
        return check.check_hybrid(ref, ctx.questions, ctx.results,
                                  ctx.sample, ctx.k, control=control)
    return judge

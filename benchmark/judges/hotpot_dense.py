"""The dense top-k answers against the plain reference's exact top-k
over every row (`harness.check.check_dense`): ``dense_rank_gap`` and
``dense_score_err`` over the sampled answers, with the configuration's
encoder (the learned trunk, or the hash encoder where it names none).
Controls: ``bfloat16`` queries (a single-pass scoring), or the trunk on
``float8_e4m3fn`` operands."""
from harness import check


def make(ctx):
    ctx.row_of = {(t, s): i for i, (t, s, _) in
                  enumerate(ctx.ref.flatten(ctx.samples))}
    embedded: dict = {}

    def judge(control=None):
        return check.check_dense(ctx.ref, ctx.samples, ctx.config,
                                 ctx.encoder_params, ctx.results, ctx.sample,
                                 ctx.k, ctx.device, control=control,
                                 cache=embedded)
    return judge

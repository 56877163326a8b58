"""The dense top-k answers of an instructed embedder against the plain
reference's exact top-k over every row (`harness.check.check_dense`), with
each sampled question prefixed by the configuration's
``encoder.query_instruction`` as the program prefixes its queries; rows
come unchanged from ``ref.flatten``. ``dense_rank_gap`` and
``dense_score_err`` over the sampled answers."""
from harness import check


def make(ctx):
    ctx.row_of = {(t, s): i for i, (t, s, _) in
                  enumerate(ctx.ref.flatten(ctx.samples))}
    instr = ctx.config["encoder"]["query_instruction"]
    asked = [dict(s, question=instr + s["question"]) for s in ctx.samples]
    embedded: dict = {}

    def judge(control=None):
        return check.check_dense(ctx.ref, asked, ctx.config,
                                 ctx.encoder_params, ctx.results, ctx.sample,
                                 ctx.k, ctx.device, control=control,
                                 cache=embedded)
    return judge

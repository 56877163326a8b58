"""The card's busy time per 1,000 questions answered in the window, in ms:
the union of the device ops' intervals over the window (every batch sent
has come back when it closes) over its questions. What a batch job pays
in card time, whatever the host around the card does."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or not run.questions:
        return None
    return 1e6 * t["busy_s"] / run.questions

"""The benchmark harness of the PyTorch port (``benchmark/run.py``).

Everything a cell needs is found by name (`spec`): its configuration,
mix, corpus generator, stream, entry, judge, reference and per-layer
metric readers are files of their own. This package holds what they
share: finding them, the set-up of the program (`deploy`), the window's
result (`window`), the seed streams (`seeds`), the trace reader
(`trace`), the roofline arithmetic (`roofline`) and the comparisons the
judges make (`check`).
"""

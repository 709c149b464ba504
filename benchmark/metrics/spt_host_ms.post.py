"""Host milliseconds a post step spends in the SPT working-set cut (the
budgeted cut's three candidate cuts over the forest's entries, and the
occlusion cull where it is on): the self time of the program's span
`hlod.spt_cut` inside post_iteration."""

from benchmark.harness import spans

SPANS = ("hlod.spt_cut",)


def read(r):
    return spans.self_ms(r, SPANS)

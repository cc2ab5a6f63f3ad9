"""B4's useful share of the score elements it visits, in %: the (query,
key) pairs x heads that causal attention within an episode keeps
(``portbench.counts.attention_pairs`` of each traced batch's seams, every
layer and epoch) over the score elements the forwards' tile plans visit, as
the program counts them (``tpu_rl_torch.ops.attention.count_visits``:
visited tile pairs x 64^2 x heads) over the spans pass
(``portbench.phases``). None where the counter is absent: no B4, the CPU,
or a program without it."""

from portbench.phases import read as spans


def read(run):
    split = spans(run)
    if split is None or not split.visited:
        return None
    return 100.0 * split.kept / split.visited

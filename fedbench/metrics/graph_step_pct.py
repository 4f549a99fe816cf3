"""graph_step_pct (%): the share of the per-client loop's live client-steps
that ran as a replay of the step's CUDA graph, from the program's counters:
over the unprofiled rounds after the process's first, the
``fedmlp.graph_steps`` counter over the ``fedmlp.steps`` counter, each summed.
A program without the graph counter reads nothing. Moves
``train_img_per_s``: a replayed step costs the host one launch where the
eager step launches each kernel from Python."""

from fedbench.program_spans import window_rounds


def _graph_counter():
    """The program's name of the graph-step counter, or None."""
    try:
        from fedmlp_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "GRAPH_STEPS", None)


def read(rec: dict):
    name, rounds = _graph_counter(), window_rounds() or ()
    steps = sum(r["counters"].get("fedmlp.steps", 0) for r in rounds)
    if name is None or not steps:
        return None
    return 100.0 * sum(r["counters"].get(name, 0) for r in rounds) / steps

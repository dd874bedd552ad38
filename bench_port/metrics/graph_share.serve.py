"""``graph_share.serve``: the share of the traced window's requests (its
``dat.serve`` roots) that the program served by replaying a captured CUDA
graph, those that carry its ``serve.graph`` counter, %. A program without
the graphs (no ``eval/inference.py:ForwardGraphs``) gives None."""

from bench_port.metrics.spans import _roots, recorded


def read(run):
    try:
        from dat_segmentation_tpu_torch.eval import inference
    except ImportError:
        return None
    rec = recorded()
    roots = [] if rec is None else _roots(rec, "dat.serve")
    if not hasattr(inference, "ForwardGraphs") or not roots:
        return None
    return 100.0 * sum(rec.counts.get(("serve.graph", r), 0) > 0 for r in roots) / len(roots)

"""Quickstart, in the PyTorch port: the paper's full pipeline on one
synthetic power-law graph.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. generate an RMAT graph (power-law, like the paper's SNAP workloads)
2. run PageRank in the vertex-centric engine on the device, tracing
   per-edge activity (one `segment_spmm` launch an iteration on the card)
3. partition (Algorithm 2) + place (Algorithms 3/4) onto a 2-D-mesh NoC
4. simulate (Table 3 parameters) against the randomized baseline

The lines of `examples/quickstart.py`, number for number: the trace is
float64-exact and the mapping is host numpy.  The trace runs on the card
unless `--device cpu` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.degree import out_degrees, skew_stats
from repro_torch.core.mapping import map_graph
from repro_torch.device import resolve_device
from repro_torch.graph.algorithms import pagerank_program, prepare_graph
from repro_torch.graph.generators import rmat
from repro_torch.graph.vertex_program import run_traced


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="the trace's device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. graph
    g = rmat(5_000, 80_000, seed=0, name="quickstart")
    stats = skew_stats(out_degrees(g.src, g.num_nodes))
    print(f"graph: |V|={g.num_nodes} |E|={g.num_edges}  "
          f"power-law α={stats.alpha:.2f}  "
          f"{stats.frac_vertices_for_90pct_edges:.0%} of vertices carry 90% of edges")

    # 2. trace one real execution (our GraphMAT equivalent)
    gp = prepare_graph("pagerank", g)
    trace = run_traced(gp, pagerank_program(), max_iterations=40, device=device)
    print(f"pagerank converged in {trace.num_iterations} iterations")

    # 3+4. paper mapping vs randomized baseline on a 16-engine 2-D mesh
    opt = map_graph(g.src, g.dst, g.num_nodes, 16, edge_activity=trace.edge_activity)
    base = map_graph(g.src, g.dst, g.num_nodes, 16, partitioner="random",
                     placement_method="random", edge_activity=trace.edge_activity)
    res = opt.compare_to(base, num_iterations=trace.num_iterations)
    print(f"avg hops: {res['avg_hops_baseline']:.2f} → {res['avg_hops_optimized']:.2f} "
          f"({res['hop_decrease']:.1f}× lower)")
    print(f"speedup:  {res['speedup']:.1f}×   energy: {res['energy_ratio']:.1f}× less")
    print("(paper reports 2–5× speedup, 2.7–4× energy on its four SNAP graphs)")


if __name__ == "__main__":
    main()

"""Graph containers, generators, the vertex-program engine and the paper's
three workload algorithms."""

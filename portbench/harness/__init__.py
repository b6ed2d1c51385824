"""The benchmark's harness: a cell's files found by name, the closed
loop of jobs, the trace's reduction, the comparison with the plain
reference and the result's line."""

"""The matrices of the configurations, one file a kind of problem:
`problems/<problem>.py` defines `build(config)`, which returns the matrix
as row-sorted COO triplets (rows, cols, vals, n), and the harness loads it
by the name in the configuration's "problem" key."""

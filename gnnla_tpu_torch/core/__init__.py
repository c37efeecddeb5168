"""Graph-network building blocks (only the edge aggregators so far)."""

"""Feature transformers of the algorithm library."""

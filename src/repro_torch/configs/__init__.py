"""Problem configurations of the port (the paper's matrices)."""

"""The sliding-window factor-graph solver."""

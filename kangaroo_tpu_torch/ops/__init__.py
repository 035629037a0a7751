"""Image ops: median filters and the median kernel."""

"""Applications: the SGM stereo frame and synthetic input."""

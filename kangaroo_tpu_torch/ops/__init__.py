"""Image ops: median filters and the median kernel, bilateral filters,
resampling, convolution and integral-image filters."""

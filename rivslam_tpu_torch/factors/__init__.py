"""Factor-graph pieces of the window backend: IMU preintegration, residuals,
robust kernels and the edge information from registration fitness."""

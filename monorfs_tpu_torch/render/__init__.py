"""The port's own rasterizer: batched RGB canvases on the device (canvas),
the data-to-pixel maps of 2D and 3D axes (transform), a 5x7 bitmap font
(font), matplotlib-style figures with axes, ticks, legends and titles
(axes), and a standard-library PNG writer (png). It does for the port what
matplotlib's Agg backend does for the JAX viewers, without matplotlib."""

"""The plain reference the benchmark judges the program by: plain torch and
numpy, importing nothing of the program. Given the triangles, materials,
cameras and program outputs the benchmark hands it, it works out hits,
G-buffer rows, the SVGF denoiser and the ACES tonemap again."""

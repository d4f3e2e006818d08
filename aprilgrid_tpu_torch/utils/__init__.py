"""Host-side utilities of the port: profiling and tracing
(``profiling``), the golden images without an image library and image
files with PIL (``images``)."""

"""The benchmark's plain reference: readers of the scene, OBJ and BMP
files (`files`), ray-triangle queries (`accel`), a plain PyTorch
raytracer with the upstream engine's shading (`render`), its train steps
(`train`), and the comparisons that decide `correct` (`compare`). It
imports neither the program under test nor JAX."""

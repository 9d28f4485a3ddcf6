"""Dense multi-view stereo (port of ``pycolmap_tpu/mvs``): the workspace,
PatchMatch stereo with its window-cost kernel, stereo fusion, and meshing
(Poisson on the device, the Delaunay meshers on the host)."""

"""Dense multi-view stereo (port of ``pycolmap_tpu/mvs``): the workspace,
PatchMatch stereo with its window-cost kernel, and stereo fusion.
``meshing.py`` waits for a later slice (ROADMAP.md)."""

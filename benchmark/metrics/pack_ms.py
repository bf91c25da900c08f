"""The scene pack (soa.pack_scene, the paged build cached by mesh content): the median ms a render or editor frame."""

from benchmark.harness import readers


def read(run):
    return readers.phase_median(run, lambda name: name == "pack_scene")

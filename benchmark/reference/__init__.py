"""The benchmark's plain reference: plain PyTorch, importing nothing of the port.

``lanes`` traces a render's pixels pass by pass with frozen copies of the
port's plain versions (scene model, pack and pages, camera, RNG, the two
contracts' bounce loops, fog, post); ``editor`` applies the interactive
editor's camera keys.  The benchmark hands it the same scene JSON, sizes,
seeds and keys that it hands the port, and judges the port's images and
segment counts by what it computes.
"""

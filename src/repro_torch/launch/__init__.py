"""The port's module entry points (`repro.launch`): `train` and `serve`.

    python -m repro_torch.launch.train --arch yi-9b --steps 4
    python -m repro_torch.launch.serve --requests 40

Both default to ``--device cuda`` and raise without a GPU unless the
caller asks for ``--device cpu``.  `repro`'s mesh, dry run and
performance probe come in a later slice.
"""

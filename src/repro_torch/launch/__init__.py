"""The port's module entry points (`repro.launch`).

    python -m repro_torch.launch.train --arch yi-9b --steps 4
    python -m repro_torch.launch.serve --requests 40
    python -m repro_torch.launch.dryrun --arch yi-9b --mesh single
    python -m repro_torch.launch.perf_probe --arch yi-9b --shape train_4k

`train` and `serve` default to ``--device cuda`` and raise without a GPU
unless the caller asks for ``--device cpu``.  `mesh` builds the production
meshes (256 and 512 ranks); `dryrun` traces every architecture x shape
cell on them under a fake process group and a `FakeTensorMode`, with
nothing allocated and no card needed, and `perf_probe` reports one cell's
largest buffers and collectives.
"""

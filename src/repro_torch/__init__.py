"""PyTorch/CUDA port of the VineLM reproduction (`repro` is the JAX reference).

The port keeps `repro`'s module names so each counterpart is easy to find:

- `core`     — workflow templates, the execution trie, the host controller,
               the batched device planner (`controller_torch`) and the
               scalar and fleet runtimes
- `kernels`  — hand-written CUDA kernels for Hopper (`kernels/csrc/`), their
               plain PyTorch versions, and the device dispatch in `ops`
- `models`   — the dense decoder (`Model`) and the JAX weight carrier
- `serving`  — `ServingEngine`: prefill + greedy decode on one model

Importing the package builds nothing and touches no device.  Entry points
take ``device=`` (default ``"cuda"``) and raise when no GPU is present
unless the caller asks for ``device="cpu"``.
"""

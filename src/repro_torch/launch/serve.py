"""Serving launcher (`repro.launch.serve`, ported): VineLM controlling a
workflow over the trained zoo::

    python -m repro_torch.launch.serve [--requests 40] [--device cpu]

A thin entry point over the end-to-end example: it runs
`repro_torch.examples.serve_workflow` as ``__main__`` with this command
line, every flag passed through (``--device`` included: "cuda" unless
the caller asks for "cpu").
"""
import runpy
import sys

MODULE = "repro_torch.examples.serve_workflow"


def main(argv=None) -> None:
    """Run the example as ``__main__`` on ``argv`` (the command line's
    arguments when None)."""
    saved = sys.argv
    sys.argv = [saved[0]] + (saved[1:] if argv is None else list(argv))
    try:
        runpy.run_module(MODULE, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved


if __name__ == "__main__":
    main()

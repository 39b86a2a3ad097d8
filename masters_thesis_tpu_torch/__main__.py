"""``python -m masters_thesis_tpu_torch train|test|stacked [--device cpu] ...``

``train`` is the port's ``train.py`` (``cli/train.py``), ``test`` its
``test.py`` (``cli/test.py``), ``stacked`` its ``sweeps/stacked_cell.py``
(``cli/stacked.py``: R replicas in one program). Each runs on CUDA unless
given ``--device cpu``; a failure exits non-zero. ``plots <log_dir>``
draws a ``test`` run's figures from its ``results.npz`` (matplotlib, no
card). When
``trainer.n_devices`` asks for more than one rank, each command starts
itself again as that many ranks (``parallel/launch.py``) and exits as they
do: non-zero, every rank stopped, when one of them fails.
"""

from __future__ import annotations

import sys

USAGE = ("usage: python -m masters_thesis_tpu_torch {train,test,stacked} "
         "[-m] [--device cpu] [key=value ...]\n"
         "       python -m masters_thesis_tpu_torch plots <log_dir>")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("train", "test", "stacked", "plots"):
        print(USAGE, file=sys.stderr)
        return 2
    if argv[0] == "plots":
        from masters_thesis_tpu_torch.cli.test import plots_main

        return plots_main(argv[1:])
    if argv[0] == "stacked":
        from masters_thesis_tpu_torch.cli.stacked import main as stacked_main

        return stacked_main(argv[1:])
    if argv[0] == "train":
        from masters_thesis_tpu_torch.cli.train import main as train_main

        return train_main(argv[1:])
    from masters_thesis_tpu_torch.cli.test import main as test_main

    return test_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())

"""CLI: python -m nextgen_uia_tpu_torch.tasks.dino.classification ..."""

from ..other_tasks import dino_classification_main


def main(argv=None):
    return dino_classification_main(argv)


if __name__ == "__main__":
    main()

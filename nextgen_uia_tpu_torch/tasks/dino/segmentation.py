"""CLI: python -m nextgen_uia_tpu_torch.tasks.dino.segmentation ..."""

from ..other_tasks import dino_segmentation_main


def main(argv=None):
    return dino_segmentation_main(argv)


if __name__ == "__main__":
    main()

"""CLI: python -m nextgen_uia_tpu_torch.tasks.clipseg.segmentation ..."""

from ..other_tasks import clipseg_segmentation_main


def main(argv=None):
    return clipseg_segmentation_main(argv)


if __name__ == "__main__":
    main()

"""CLI: python -m nextgen_uia_tpu_torch.tasks.metaclip.segmentation ..."""

from ..clip_tasks import supervised_main


def main(argv=None):
    return supervised_main("metaclip", "seg", argv)


if __name__ == "__main__":
    main()

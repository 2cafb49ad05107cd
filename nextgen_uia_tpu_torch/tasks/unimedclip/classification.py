"""CLI: python -m nextgen_uia_tpu_torch.tasks.unimedclip.classification ..."""

from ..clip_tasks import supervised_main


def main(argv=None):
    return supervised_main("unimedclip", "cls", argv)


if __name__ == "__main__":
    main()

"""CLI: python -m nextgen_uia_tpu_torch.tasks.metaclip.classification ..."""

from ..clip_tasks import supervised_main


def main(argv=None):
    return supervised_main("metaclip", "cls", argv)


if __name__ == "__main__":
    main()

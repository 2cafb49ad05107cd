"""CLI: python -m nextgen_uia_tpu_torch.tasks.metaclip.zero_shot --dataset BUSI ..."""

from ..clip_tasks import zero_shot_main


def main(argv=None):
    return zero_shot_main("metaclip", argv)


if __name__ == "__main__":
    main()

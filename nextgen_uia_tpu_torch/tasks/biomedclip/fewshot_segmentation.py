"""CLI: python -m nextgen_uia_tpu_torch.tasks.biomedclip.fewshot_segmentation ..."""

from ..clip_tasks import supervised_main


def main(argv=None):
    return supervised_main("biomedclip", "seg", argv, fewshot=True)


if __name__ == "__main__":
    main()

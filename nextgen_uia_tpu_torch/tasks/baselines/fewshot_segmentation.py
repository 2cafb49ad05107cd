"""CLI: python -m nextgen_uia_tpu_torch.tasks.baselines.fewshot_segmentation ..."""

from ..other_tasks import baselines_segmentation_main


def main(argv=None):
    return baselines_segmentation_main(argv, fewshot=True)


if __name__ == "__main__":
    main()

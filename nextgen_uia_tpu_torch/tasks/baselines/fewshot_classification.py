"""CLI: python -m nextgen_uia_tpu_torch.tasks.baselines.fewshot_classification ..."""

from ..other_tasks import baselines_classification_main


def main(argv=None):
    return baselines_classification_main(argv, fewshot=True)


if __name__ == "__main__":
    main()

"""CLI: python -m nextgen_uia_tpu_torch.tasks.baselines.predict --task cls|seg ..."""

from ..serve import predict_main


def main(argv=None):
    return predict_main("baselines", argv)


if __name__ == "__main__":
    main()

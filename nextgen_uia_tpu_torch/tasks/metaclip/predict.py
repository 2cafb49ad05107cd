"""CLI: python -m nextgen_uia_tpu_torch.tasks.metaclip.predict --task zero_shot|cls|seg ..."""

from ..serve import predict_main


def main(argv=None):
    return predict_main("metaclip", argv)


if __name__ == "__main__":
    main()

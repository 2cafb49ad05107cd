"""CLI: python -m nextgen_uia_tpu_torch.tasks.unimedclip.predict --task zero_shot|cls|seg ..."""

from ..serve import predict_main


def main(argv=None):
    return predict_main("unimedclip", argv)


if __name__ == "__main__":
    main()

"""CLI: python -m nextgen_uia_tpu_torch.tasks.biomedclip.predict --task seg|cls ..."""

from ..serve import predict_main


def main(argv=None):
    return predict_main("biomedclip", argv)


if __name__ == "__main__":
    main()

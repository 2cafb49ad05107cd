"""CLI: python -m nextgen_uia_tpu_torch.tasks.clipseg.predict --images <dir> ..."""

from ..serve import predict_main


def main(argv=None):
    return predict_main("clipseg", argv)


if __name__ == "__main__":
    main()

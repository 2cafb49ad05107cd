"""CLI: python -m nextgen_uia_tpu_torch.tasks.dino.predict --task seg|cls ..."""

from ..serve import predict_main


def main(argv=None):
    return predict_main("dino", argv)


if __name__ == "__main__":
    main()

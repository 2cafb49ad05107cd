"""CLI: python -m nextgen_uia_tpu_torch.tasks.biomedclip.retrieval --csv <pairs.csv> --img_dir <dir> ..."""

from ..clip_finetune import retrieval_main


def main(argv=None):
    return retrieval_main("biomedclip", argv)


if __name__ == "__main__":
    main()

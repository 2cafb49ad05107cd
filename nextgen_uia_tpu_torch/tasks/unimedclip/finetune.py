"""CLI: python -m nextgen_uia_tpu_torch.tasks.unimedclip.finetune --method lora|mona ..."""

from ..clip_finetune import finetune_main


def main(argv=None):
    return finetune_main("unimedclip", argv)


if __name__ == "__main__":
    main()

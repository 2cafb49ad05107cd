"""CLI: python -m nextgen_uia_tpu_torch.tasks.biomedclip.finetune --method mona|lora ...

BiomedCLIP's contrastive fine-tune (ViT-B/16 with MONA or LoRA, the frozen
PubMedBERT text tower); the reference defaults: 32 epochs,
``freq_enhanced`` MONA.
"""

from ..clip_finetune import finetune_main


def main(argv=None):
    return finetune_main("biomedclip", argv)


if __name__ == "__main__":
    main()

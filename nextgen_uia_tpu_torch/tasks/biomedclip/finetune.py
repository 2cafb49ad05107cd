"""CLI: python -m nextgen_uia_tpu_torch.tasks.biomedclip.finetune --method mona|lora ...

BiomedCLIP's contrastive fine-tune (ViT-B/16 with MONA or LoRA, the
PubMedBERT text tower frozen, or with ``--tune_text_encoder`` encoded in the
step and, with LoRA, LoRA in its layers too); the reference defaults: 32
epochs, ``freq_enhanced`` MONA.
"""

from ..clip_finetune import finetune_main


def main(argv=None):
    return finetune_main("biomedclip", argv)


if __name__ == "__main__":
    main()

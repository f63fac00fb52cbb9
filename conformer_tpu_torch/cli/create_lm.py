"""Build the LM files from a text corpus: lm_text.txt, lexicon.txt, lm.arpa
(counterpart of conformer_tpu/cli/create_lm.py).

    python -m conformer_tpu_torch.cli.create_lm --text corpus.txt --out lm_dir

The corpus is cleaned and upper-cased with the run's tokenizer
(``--tokenizer``, or ``train.tokenizer_path`` of ``--config``), so that the
lexicon and the LM's words match the model's at decode time. The ARPA
(interpolated modified Kneser-Ney, order ``--order``) comes from the native
builder (``conformer_tpu_torch/native/ngram_lm.cpp``), built with ``g++``
at first use. ``--token-level`` also writes lm_tokens.txt and
lm_tokens.arpa over the grapheme tokens, for the device beam search.
"""

from __future__ import annotations

import argparse
import os

from conformer_tpu_torch.cli.common import (add_common_args, add_mesh_args,
                                            load_config,
                                            load_tokenizer_from_args,
                                            refuse_mesh)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--text", required=True,
                   help="input corpus, one sentence per line")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--order", type=int, default=5)
    p.add_argument("--token-level", action="store_true",
                   help="also train lm_tokens.arpa over grapheme-token "
                        "sequences (decode.device_lm_path)")
    p.add_argument("--token-order", type=int, default=5)
    args = p.parse_args(argv)
    refuse_mesh(args, "cli.create_lm")

    cfg = load_config(args)
    tok = load_tokenizer_from_args(args, cfg)
    os.makedirs(args.out, exist_ok=True)

    texts = []
    with open(args.text, encoding="utf8") as f:
        for line in f:
            cleaned = tok.clean_text(str(line).upper())
            if cleaned:
                texts.append(cleaned)
    lm_text = os.path.join(args.out, "lm_text.txt")
    with open(lm_text, "w", encoding="utf8") as f:
        f.write("\n".join(texts))

    # Lexicon: word -> graphemes + delimiter, skipping words whose
    # segmentation holds <UNK>.
    seen = set()
    lexicon = []
    for text in texts:
        for word in text.split(" "):
            if not word or word in seen:
                continue
            seen.add(word)
            graphemes = tok.word2graphemes(word)
            if tok.unk_token in graphemes:
                continue
            lexicon.append(f"{word} {' '.join(graphemes)} {tok.delim_token}")
    with open(os.path.join(args.out, "lexicon.txt"), "w", encoding="utf8") as f:
        f.write("\n".join(lexicon))

    from conformer_tpu_torch.lm.ngram import build_arpa

    arpa = os.path.join(args.out, "lm.arpa")
    build_arpa(lm_text, arpa, order=args.order)
    print(f"wrote {lm_text}, lexicon.txt ({len(lexicon)} words), {arpa}")

    if args.token_level:
        tok_text = os.path.join(args.out, "lm_tokens.txt")
        with open(tok_text, "w", encoding="utf8") as f:
            for text in texts:
                ids = tok.encode(text)
                f.write(" ".join(tok.vocab[i] for i in ids) + "\n")
        tok_arpa = os.path.join(args.out, "lm_tokens.arpa")
        build_arpa(tok_text, tok_arpa, order=args.token_order)
        print(f"wrote {tok_text}, {tok_arpa} (token-level, "
              f"order {args.token_order})")


if __name__ == "__main__":
    main()

"""Dataset-specific filelist builders -> "audio_path|text" lines
(reference: recipes/*.py — 7 scripts consolidated into one module). The
port's copy of the JAX package's `data/recipes.py`.

Each builder returns the list of lines and writes them if `output` is given.
All use ThreadPool/serial IO rather than the reference's ProcessPoolExecutor —
these are metadata walks, not compute.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import List, Optional


def _write(lines: List[str], output: Optional[str]) -> List[str]:
    if output:
        os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
        with open(output, "w", encoding="utf-8") as f:
            f.writelines(lines)
    return lines


def libri_tts(dataset_path: str, output: Optional[str] = None) -> List[str]:
    """LibriTTS: *.wav + sibling *.normalized.txt (reference: recipes/libriTTS.py).
    download: https://openslr.org/60/"""
    lines = []
    for wav in sorted(Path(dataset_path).rglob("*.wav")):
        txt = wav.with_suffix(".normalized.txt")
        if txt.exists():
            text = txt.read_text(encoding="utf-8").strip()
            lines.append(f"{wav.as_posix()}|{text}\n")
    return _write(lines, output)


def aishell3(dataset_path: str, txt_path: str, output: Optional[str] = None) -> List[str]:
    """AiSHELL-3: content.txt with per-utterance pinyin-annotated text
    (reference: recipes/AiSHELL3.py). download: https://www.openslr.org/93/"""
    lines = []
    with open(txt_path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(maxsplit=1)
            if len(parts) != 2:
                continue
            audio_name, text = parts
            # content.txt interleaves hanzi with tone-numbered pinyin tokens;
            # drop only those tokens so embedded Latin words/digits that the
            # zh frontend can verbalize survive (e.g. product names)
            text = re.sub(r"\b[a-zA-Z]+[1-5]\b", "", text)
            text = re.sub(r"\s+", "", text)
            audio = os.path.abspath(os.path.join(dataset_path, audio_name[:7], audio_name))
            if os.path.exists(audio):
                lines.append(f"{audio}|{text}\n")
    return _write(lines, output)


def bznsyp(dataset_path: str, txt_path: str, output: Optional[str] = None) -> List[str]:
    """BZNSYP (DataBaker): prosody-labeled transcript
    (reference: recipes/BZNSYP_标贝女声.py)."""
    lines = []
    with open(txt_path, encoding="utf-8") as f:
        for line in f:
            if "\t" not in line:
                continue  # pinyin annotation lines
            audio_name, text = line.split("\t", 1)
            text = re.sub(r"[#\d]+", "", text).strip()
            audio = os.path.abspath(os.path.join(dataset_path, f"{audio_name}.wav"))
            if os.path.exists(audio):
                lines.append(f"{audio}|{text}\n")
    return _write(lines, output)


def hifi_tts(dataset_path: str, output: Optional[str] = None) -> List[str]:
    """Hi-Fi TTS: per-speaker json manifests (reference: recipes/hifi_tts.py).
    download: https://www.openslr.org/109/"""
    lines = []
    for manifest in sorted(Path(dataset_path).rglob("*.json")):
        with open(manifest, encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                audio = os.path.abspath(os.path.join(dataset_path, rec["audio_filepath"]))
                if os.path.exists(audio):
                    lines.append(f"{audio}|{rec['text_normalized']}\n")
    return _write(lines, output)


def vctk_parquet(
    dataset_path: str, output_audio_path: str, output: Optional[str] = None
) -> List[str]:
    """VCTK from huggingface parquet shards: extracts embedded audio to wav
    files (reference: recipes/VCTK_huggingface.py). Payloads that are not
    WAV are skipped (the recipe decodes WAV only)."""
    import pandas as pd

    from stabletts_torch.utils.audio_io import save_wav

    os.makedirs(output_audio_path, exist_ok=True)
    lines = []
    for parquet in sorted(Path(dataset_path).rglob("*.parquet")):
        df = pd.read_parquet(parquet)
        for _, row in df.iterrows():
            payload = row["audio"]["bytes"]
            name = os.path.basename(row["audio"]["path"])
            out_path = os.path.abspath(os.path.join(output_audio_path, name))
            if payload[:4] == b"RIFF":  # wav container
                with open(out_path, "wb") as f:
                    f.write(payload)
            else:
                import io

                from scipy.io import wavfile

                try:
                    sr, data = wavfile.read(io.BytesIO(payload))
                    save_wav(out_path, data.astype("float32") / 32768.0, sr)
                except Exception:
                    continue
            lines.append(f"{out_path}|{row['text']}\n")
    return _write(lines, output)


_GENSHIN_FORBIDDEN = re.compile(
    "|".join(
        re.escape(t)
        for t in ["……", "{NICKNAME}", "#", "(", ")", "♪", "test", "{0}", "█", "*", "+", "Gohus"]
    )
)


def _genshin_clean(text: str, forbid_latin: bool) -> Optional[str]:
    if forbid_latin and re.search(r"[A-Za-z0-9]", text):
        return None
    if _GENSHIN_FORBIDDEN.search(text):
        return None
    return text.replace("$UNRELEASED", "")


def genshin(
    dataset_path: str,
    excel_path: str,
    output: Optional[str] = None,
    language: str = "zh",
) -> List[str]:
    """Genshin voice packs indexed by the community Excel sheet
    (reference: recipes/genshin_{zh,en}_小虫哥ver.py). Requires openpyxl."""
    try:
        import openpyxl
    except ImportError as e:
        raise ImportError("the genshin recipe needs openpyxl for the Excel index") from e

    wb = openpyxl.load_workbook(excel_path)
    main = wb[wb.sheetnames[0]]
    npc_names = [c.value for c in main["B"] if c.value][1:]
    lines = []
    for npc in npc_names:
        if npc not in wb.sheetnames:
            continue
        sheet = wb[npc]
        # filter rows JOINTLY: filtering the two columns independently would
        # shift one list past the other at any row with an empty cell and
        # misalign every following (audio, text) pair
        rows = [
            (c_cell.value, d_cell.value)
            for c_cell, d_cell in zip(sheet["C"], sheet["D"])
            if c_cell.value and d_cell.value
        ][1:]
        for audio_name, text in rows:
            audio = os.path.abspath(os.path.join(dataset_path, npc, str(audio_name)))
            if not os.path.exists(audio):
                continue
            cleaned = _genshin_clean(str(text), forbid_latin=(language == "zh"))
            if cleaned:
                lines.append(f"{audio}|{cleaned}\n")
    return _write(lines, output)


RECIPES = {
    "libritts": libri_tts,
    "aishell3": aishell3,
    "bznsyp": bznsyp,
    "hifi_tts": hifi_tts,
    "vctk": vctk_parquet,
    "genshin": genshin,
}

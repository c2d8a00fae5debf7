"""Desktop GUI client for the TTS HTTP API (the port's own copy of
gpt_sovits_tpu/serve/gui_client.py).

Counterpart of the reference's PyQt5 client (GPT_SoVITS/inference_gui.py:
1-316), a thin desktop front end over the serving API. The shell is
tkinter (standard library), and unlike the reference (which imports
inference_webui and runs the models in-process) this is a pure REST client
of the api_v2-compatible server (`serve/api.py serve`), so the GUI needs no
accelerator and can point at a remote host.

The non-GUI core (`TTSClient`) imports without a display and is tested
against a live test server; `main()` builds the Tk UI around it.

Usage: python -m gpt_sovits_tpu_torch.serve.gui_client [--server http://host:port]
"""

from __future__ import annotations

import argparse
import json
import urllib.error
import urllib.parse
import urllib.request

LANGS = ("auto", "zh", "en", "ja", "ko", "yue", "all_zh", "all_ja", "all_ko", "all_yue")


class TTSClient:
    """REST client for the api_v2-compatible server (serve/api.py)."""

    def __init__(self, base_url: str = "http://127.0.0.1:9880", timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str, params: dict | None = None) -> tuple[int, bytes]:
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def _post(self, path: str, body: dict) -> tuple[int, bytes]:
        req = urllib.request.Request(
            self.base_url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def health(self) -> bool:
        try:
            code, _ = self._get("/health")
            return code == 200
        except (urllib.error.URLError, OSError):
            return False

    def set_gpt_weights(self, path: str) -> tuple[bool, str]:
        code, body = self._get("/set_gpt_weights", {"weights_path": path})
        return code == 200, body.decode(errors="replace")

    def set_sovits_weights(self, path: str) -> tuple[bool, str]:
        code, body = self._get("/set_sovits_weights", {"weights_path": path})
        return code == 200, body.decode(errors="replace")

    def tts(
        self,
        text: str,
        text_lang: str,
        ref_audio_path: str,
        prompt_text: str = "",
        prompt_lang: str = "auto",
        **extra,
    ) -> tuple[bool, bytes | str]:
        """-> (ok, wav bytes | error message)."""
        body = {
            "text": text,
            "text_lang": text_lang,
            "ref_audio_path": ref_audio_path,
            "prompt_text": prompt_text,
            "prompt_lang": prompt_lang,
            "media_type": "wav",
            **extra,
        }
        code, data = self._post("/tts", body)
        if code == 200 and data[:4] == b"RIFF":
            return True, data
        try:
            msg = json.loads(data).get("message", data.decode(errors="replace"))
        except ValueError:
            msg = data.decode(errors="replace")
        return False, msg


def synthesize_to_file(client: TTSClient, out_path: str, **kwargs) -> str:
    """Core action behind the GUI's synthesize button; returns out_path.
    Raises RuntimeError with the server's message on failure."""
    ok, result = client.tts(**kwargs)
    if not ok:
        raise RuntimeError(str(result))
    with open(out_path, "wb") as f:
        f.write(result)  # type: ignore[arg-type]
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description="GPT-SoVITS desktop client")
    parser.add_argument("--server", default="http://127.0.0.1:9880")
    args = parser.parse_args(argv)

    import tkinter as tk
    from tkinter import filedialog, messagebox, ttk

    client = TTSClient(args.server)

    root = tk.Tk()
    root.title("gpt_sovits_tpu_torch client")
    root.geometry("720x560")
    frm = ttk.Frame(root, padding=12)
    frm.grid(sticky="nsew")
    root.columnconfigure(0, weight=1)
    root.rowconfigure(0, weight=1)
    frm.columnconfigure(1, weight=1)

    def row(r, label):
        ttk.Label(frm, text=label).grid(row=r, column=0, sticky="w", pady=2)

    server_var = tk.StringVar(value=args.server)
    row(0, "Server")
    ttk.Entry(frm, textvariable=server_var).grid(row=0, column=1, columnspan=2, sticky="ew")

    gpt_var = tk.StringVar()
    sovits_var = tk.StringVar()
    for r, (label, var, setter) in enumerate(
        [("GPT weights", gpt_var, "set_gpt_weights"), ("SoVITS weights", sovits_var, "set_sovits_weights")],
        start=1,
    ):
        row(r, label)
        ttk.Entry(frm, textvariable=var).grid(row=r, column=1, sticky="ew")

        def browse(v=var):
            p = filedialog.askopenfilename()
            if p:
                v.set(p)

        ttk.Button(frm, text="...", width=3, command=browse).grid(row=r, column=2)

    def apply_weights():
        client.base_url = server_var.get().rstrip("/")
        for var, fn in ((gpt_var, client.set_gpt_weights), (sovits_var, client.set_sovits_weights)):
            if var.get():
                ok, msg = fn(var.get())
                if not ok:
                    messagebox.showerror("weights", msg)
                    return
        status.set("weights applied")

    ttk.Button(frm, text="Apply weights", command=apply_weights).grid(row=3, column=1, sticky="w", pady=4)

    ref_var = tk.StringVar()
    row(4, "Reference audio")
    ttk.Entry(frm, textvariable=ref_var).grid(row=4, column=1, sticky="ew")
    ttk.Button(frm, text="...", width=3,
               command=lambda: ref_var.set(filedialog.askopenfilename() or ref_var.get())).grid(row=4, column=2)

    row(5, "Reference text")
    prompt_text = tk.Text(frm, height=2)
    prompt_text.grid(row=5, column=1, columnspan=2, sticky="ew")
    prompt_lang = tk.StringVar(value="auto")
    row(6, "Reference language")
    ttk.Combobox(frm, textvariable=prompt_lang, values=LANGS, state="readonly").grid(row=6, column=1, sticky="w")

    row(7, "Text")
    text_box = tk.Text(frm, height=8)
    text_box.grid(row=7, column=1, columnspan=2, sticky="nsew")
    frm.rowconfigure(7, weight=1)
    text_lang = tk.StringVar(value="auto")
    row(8, "Text language")
    ttk.Combobox(frm, textvariable=text_lang, values=LANGS, state="readonly").grid(row=8, column=1, sticky="w")

    status = tk.StringVar(value="ready")

    def synthesize():
        client.base_url = server_var.get().rstrip("/")
        out = filedialog.asksaveasfilename(defaultextension=".wav", initialfile="output.wav")
        if not out:
            return
        status.set("synthesizing...")
        root.update_idletasks()
        try:
            synthesize_to_file(
                client, out,
                text=text_box.get("1.0", "end").strip(),
                text_lang=text_lang.get(),
                ref_audio_path=ref_var.get(),
                prompt_text=prompt_text.get("1.0", "end").strip(),
                prompt_lang=prompt_lang.get(),
            )
            status.set(f"wrote {out}")
            for player in ("aplay", "paplay", "afplay"):
                from shutil import which

                if which(player):
                    import subprocess

                    subprocess.Popen([player, out])
                    break
        except RuntimeError as e:
            status.set("error")
            messagebox.showerror("synthesis failed", str(e))

    ttk.Button(frm, text="Synthesize", command=synthesize).grid(row=9, column=1, sticky="w", pady=6)
    ttk.Label(frm, textvariable=status, foreground="gray").grid(row=10, column=0, columnspan=3, sticky="w")

    if not client.health():
        status.set(f"warning: no server at {args.server} (start one with serve/api.py serve)")

    root.mainloop()


if __name__ == "__main__":
    main()

"""Gradio web app, the counterpart of ``artalk_tpu/app_gradio.py`` (the
reference UI, inference.py:98-210).

Audio upload / text->TTS input, appearance + style dropdowns, mp4 + motion
download, over the port's engine (on the card unless it was built with
``device="cpu"``). Gradio and gTTS are optional dependencies, imported inside
the functions that use them: the module imports without them, and the app
reports clearly when they are unavailable.
"""

from __future__ import annotations

import os

import numpy as np

from .utils.audio import load_audio_16k_mono

GTTS_LANGS = {"English": "en", "中文": "zh", "日本語": "ja", "Deutsch": "de",
              "Français": "fr", "Español": "es"}


def synthesize_tts(text: str, language: str, out_dir: str) -> str:
    """Text -> speech wav via gTTS (network service; reference
    inference.py:106-110). Raises ImportError when gTTS is absent."""
    from gtts import gTTS  # optional dependency

    path = os.path.join(out_dir, "tts_output.wav")
    gTTS(text=text, lang=GTTS_LANGS[language]).save(path)
    return path


def process_request(engine, input_type, audio_input, text_input, text_language,
                    shape_id, style_id, warn=print, tts=synthesize_tts):
    """The app's generate callback, UI-framework-free (reference
    inference.py:99-125): validate input, optional text->TTS, style select,
    inference + rendering, motion-sequence save.

    Returns (video_path, motions_path), or (None, None) after ``warn`` on
    invalid input. ``tts`` is injectable so tests (and offline deployments)
    can substitute the network TTS service.
    """
    if input_type == "Audio" and audio_input is None:
        warn("Please upload an audio file")
        return None, None
    if input_type == "Text" and not (text_input or "").strip():
        warn("Please input text content")
        return None, None
    if input_type == "Text":
        audio_input = tts(text_input, text_language, engine.output_dir)
    audio = load_audio_16k_mono(audio_input)
    if style_id == "default":
        engine.style_motion = None
    else:
        engine.set_style_motion(style_id)
    pred_motions = engine.inference(audio)
    base = os.path.splitext(os.path.basename(audio_input))[0]
    save_name = f"{base}_{style_id.replace('.', '_')}_{shape_id.replace('.', '_')}"
    video_path = engine.rendering(audio, pred_motions, shape_id=shape_id,
                                  save_name=save_name)
    motion_path = os.path.join(engine.output_dir, f"{save_name}_motions.npy")
    np.save(motion_path, pred_motions)
    return video_path, motion_path


def run_gradio_app(engine, server_name: str = "0.0.0.0", server_port: int = 8960):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; the CLI path "
            "(python -m artalk_tpu_torch.cli -a <wav>) provides the same pipeline"
        ) from e

    def process_audio(input_type, audio_input, text_input, text_language,
                      shape_id, style_id):
        return process_request(engine, input_type, audio_input, text_input,
                               text_language, shape_id, style_id,
                               warn=gr.Warning)

    avatar_ids = sorted(getattr(engine, "gagavatar", None)
                        and engine.gagavatar.all_gagavatar_id.keys() or [])
    style_dir = os.path.join(engine.assets_dir, "style_motion")
    style_ids = sorted(
        os.path.splitext(f)[0] for f in os.listdir(style_dir)
        if f.endswith((".npy", ".pt"))
    ) if os.path.isdir(style_dir) else []

    with gr.Blocks(title="ARTalk: Speech-Driven 3D Head Animation") as demo:
        gr.Markdown("# ARTalk\nSpeech-driven 3D head animation on PyTorch/CUDA.")
        with gr.Row():
            with gr.Column():
                input_type = gr.Radio(choices=["Audio", "Text"], value="Audio",
                                      label="Input type")
                audio_input = gr.Audio(type="filepath", label="Input Audio")
                text_input = gr.Textbox(label="Input Text", visible=False)
                text_language = gr.Dropdown(choices=list(GTTS_LANGS), value="English",
                                            label="Text language", visible=False)
            with gr.Column():
                appearance = gr.Dropdown(choices=["mesh"] + avatar_ids, value="mesh",
                                         label="Appearance")
                style = gr.Dropdown(choices=["default"] + style_ids, value="default",
                                    label="Style")
            with gr.Column():
                video_output = gr.Video(autoplay=True)
                motion_output = gr.File(label="motion sequence")
        btn = gr.Button("Generate")
        btn.click(fn=process_audio,
                  inputs=[input_type, audio_input, text_input, text_language,
                          appearance, style],
                  outputs=[video_output, motion_output])

        def toggle(choice):
            audio_vis = choice == "Audio"
            return (gr.update(visible=audio_vis), gr.update(visible=not audio_vis),
                    gr.update(visible=not audio_vis))

        input_type.change(fn=toggle, inputs=[input_type],
                          outputs=[audio_input, text_input, text_language])

    demo.launch(server_name=server_name, server_port=server_port)

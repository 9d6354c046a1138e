// gloracle — headless software-GL single-pass shader executor.
//
// The rigorous parity oracle for retrocapture_tpu: runs one GLSL pass on
// Mesa llvmpipe (EGL surfaceless, GL compatibility profile) exactly as a
// GL driver would — same compiler, same filtering, same FBO formats — so
// the JAX engine's output can be PSNR-checked against REAL GL without a
// GPU or display. The Python driver (retrocapture_tpu/parity/oracle.py)
// owns preset parsing, the pass graph, and the RetroArch uniform
// protocol; this binary is a dumb, crash-isolated executor.
//
// Protocol (stdin/stdout, little-endian):
//   request:  u32 header_len | JSON header | texture blobs (f32 RGBA)
//   response: u32 status (0=ok) | u32 payload_len | payload
//             ok: out_w*out_h*4 f32   err: utf-8 message
// Header JSON:
//   { "vs": str, "fs": str, "out_w": int, "out_h": int,
//     "fbo": "rgba8"|"rgba32f"|"srgb8",
//     "textures": [ {"name": str, "w": int, "h": int,
//                    "linear": bool, "wrap": "clamp_to_edge"|..., "mipmap": bool} ],
//     "uniforms": [ {"name": str, "kind": "f"|"i"|"2f"|"3f"|"4f"|"m4",
//                    "v": [floats]} ] }
//
// All GL/EGL entry points are resolved at runtime via dlopen +
// eglGetProcAddress (the image ships Mesa runtime libs but no headers),
// the same pattern as the reference's hand-rolled loader
// (src/renderer/glad_loader.cpp).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <string>
#include <vector>

// ---- minimal EGL/GL declarations (Khronos ABI) ---------------------------
typedef void *EGLDisplay, *EGLContext, *EGLConfig, *EGLSurface;
typedef int32_t EGLint;
typedef uint32_t EGLBoolean, EGLenum;
typedef uint32_t GLenum, GLuint, GLbitfield;
typedef int32_t GLint, GLsizei;
typedef uint8_t GLubyte;
typedef float GLfloat;
typedef char GLchar;
typedef int8_t GLboolean;

#define EGL_PLATFORM_SURFACELESS_MESA 0x31DD
#define EGL_OPENGL_API 0x30A2
#define EGL_SURFACE_TYPE 0x3033
#define EGL_PBUFFER_BIT 0x0001
#define EGL_RENDERABLE_TYPE 0x3040
#define EGL_OPENGL_BIT 0x0008
#define EGL_CONTEXT_MAJOR_VERSION 0x3098
#define EGL_CONTEXT_MINOR_VERSION 0x30FB
#define EGL_CONTEXT_OPENGL_PROFILE_MASK 0x30FD
#define EGL_CONTEXT_OPENGL_COMPAT_BIT 0x00000002
#define EGL_NONE 0x3038

#define GL_COLOR_BUFFER_BIT 0x4000
#define GL_TRIANGLE_STRIP 0x0005
#define GL_FLOAT 0x1406
#define GL_RGBA 0x1908
#define GL_RGBA8 0x8058
#define GL_RGBA32F 0x8814
#define GL_SRGB8_ALPHA8 0x8C43
#define GL_TEXTURE_2D 0x0DE1
#define GL_TEXTURE0 0x84C0
#define GL_TEXTURE_MIN_FILTER 0x2801
#define GL_TEXTURE_MAG_FILTER 0x2800
#define GL_TEXTURE_WRAP_S 0x2802
#define GL_TEXTURE_WRAP_T 0x2803
#define GL_NEAREST 0x2600
#define GL_LINEAR 0x2601
#define GL_LINEAR_MIPMAP_LINEAR 0x2703
#define GL_CLAMP_TO_EDGE 0x812F
#define GL_CLAMP_TO_BORDER 0x812D
#define GL_REPEAT 0x2901
#define GL_MIRRORED_REPEAT 0x8370
#define GL_FRAMEBUFFER 0x8D40
#define GL_COLOR_ATTACHMENT0 0x8CE0
#define GL_FRAMEBUFFER_COMPLETE 0x8CD5
#define GL_FRAMEBUFFER_SRGB 0x8DB9
#define GL_VERTEX_SHADER 0x8B31
#define GL_FRAGMENT_SHADER 0x8B30
#define GL_COMPILE_STATUS 0x8B81
#define GL_LINK_STATUS 0x8B82
#define GL_INFO_LOG_LENGTH 0x8B84
#define GL_ARRAY_BUFFER 0x8892
#define GL_STATIC_DRAW 0x88E4
#define GL_TEXTURE_BORDER_COLOR 0x1004
#define GL_PACK_ALIGNMENT 0x0D05
#define GL_UNPACK_ALIGNMENT 0x0CF5
#define GL_BLEND 0x0BE2
#define GL_DEPTH_TEST 0x0B71

#define DECL(ret, name, args) static ret(*name) args = nullptr
DECL(GLuint, glCreateShader, (GLenum));
DECL(void, glShaderSource, (GLuint, GLsizei, const GLchar *const *, const GLint *));
DECL(void, glCompileShader, (GLuint));
DECL(void, glGetShaderiv, (GLuint, GLenum, GLint *));
DECL(void, glGetShaderInfoLog, (GLuint, GLsizei, GLsizei *, GLchar *));
DECL(GLuint, glCreateProgram, (void));
DECL(void, glAttachShader, (GLuint, GLuint));
DECL(void, glBindAttribLocation, (GLuint, GLuint, const GLchar *));
DECL(void, glLinkProgram, (GLuint));
DECL(void, glGetProgramiv, (GLuint, GLenum, GLint *));
DECL(void, glGetProgramInfoLog, (GLuint, GLsizei, GLsizei *, GLchar *));
DECL(void, glUseProgram, (GLuint));
DECL(void, glDeleteShader, (GLuint));
DECL(void, glDeleteProgram, (GLuint));
DECL(GLint, glGetUniformLocation, (GLuint, const GLchar *));
DECL(void, glUniform1i, (GLint, GLint));
DECL(void, glUniform1f, (GLint, GLfloat));
DECL(void, glUniform2f, (GLint, GLfloat, GLfloat));
DECL(void, glUniform3f, (GLint, GLfloat, GLfloat, GLfloat));
DECL(void, glUniform4f, (GLint, GLfloat, GLfloat, GLfloat, GLfloat));
DECL(void, glUniformMatrix4fv, (GLint, GLsizei, GLboolean, const GLfloat *));
DECL(void, glGenTextures, (GLsizei, GLuint *));
DECL(void, glDeleteTextures, (GLsizei, const GLuint *));
DECL(void, glBindTexture, (GLenum, GLuint));
DECL(void, glActiveTexture, (GLenum));
DECL(void, glTexImage2D,
     (GLenum, GLint, GLint, GLsizei, GLsizei, GLint, GLenum, GLenum, const void *));
DECL(void, glTexParameteri, (GLenum, GLenum, GLint));
DECL(void, glTexParameterfv, (GLenum, GLenum, const GLfloat *));
DECL(void, glGenerateMipmap, (GLenum));
DECL(void, glGenFramebuffers, (GLsizei, GLuint *));
DECL(void, glDeleteFramebuffers, (GLsizei, const GLuint *));
DECL(void, glBindFramebuffer, (GLenum, GLuint));
DECL(void, glFramebufferTexture2D, (GLenum, GLenum, GLenum, GLuint, GLint));
DECL(GLenum, glCheckFramebufferStatus, (GLenum));
DECL(void, glViewport, (GLint, GLint, GLsizei, GLsizei));
DECL(void, glClearColor, (GLfloat, GLfloat, GLfloat, GLfloat));
DECL(void, glClear, (GLbitfield));
DECL(void, glDrawArrays, (GLenum, GLint, GLsizei));
DECL(void, glReadPixels, (GLint, GLint, GLsizei, GLsizei, GLenum, GLenum, void *));
DECL(void, glGenBuffers, (GLsizei, GLuint *));
DECL(void, glBindBuffer, (GLenum, GLuint));
DECL(void, glBufferData, (GLenum, intptr_t, const void *, GLenum));
DECL(void, glVertexAttribPointer,
     (GLuint, GLint, GLenum, GLboolean, GLsizei, const void *));
DECL(void, glEnableVertexAttribArray, (GLuint));
DECL(void, glGenVertexArrays, (GLsizei, GLuint *));
DECL(void, glBindVertexArray, (GLuint));
DECL(void, glEnable, (GLenum));
DECL(void, glDisable, (GLenum));
DECL(void, glPixelStorei, (GLenum, GLint));
DECL(void, glFinish, (void));
#undef DECL

static void *(*egl_get_proc)(const char *) = nullptr;

static bool load_gl() {
    void *libegl = dlopen("libEGL.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!libegl) return false;
    egl_get_proc = (void *(*)(const char *))dlsym(libegl, "eglGetProcAddress");
    if (!egl_get_proc) return false;

    EGLDisplay (*getPlatDpy)(EGLenum, void *, const EGLint *) =
        (EGLDisplay(*)(EGLenum, void *, const EGLint *))egl_get_proc(
            "eglGetPlatformDisplayEXT");
    EGLBoolean (*init)(EGLDisplay, EGLint *, EGLint *) =
        (EGLBoolean(*)(EGLDisplay, EGLint *, EGLint *))dlsym(libegl, "eglInitialize");
    EGLBoolean (*bindAPI)(EGLenum) =
        (EGLBoolean(*)(EGLenum))dlsym(libegl, "eglBindAPI");
    EGLBoolean (*chooseCfg)(EGLDisplay, const EGLint *, EGLConfig *, EGLint, EGLint *) =
        (EGLBoolean(*)(EGLDisplay, const EGLint *, EGLConfig *, EGLint, EGLint *))dlsym(
            libegl, "eglChooseConfig");
    EGLContext (*createCtx)(EGLDisplay, EGLConfig, EGLContext, const EGLint *) =
        (EGLContext(*)(EGLDisplay, EGLConfig, EGLContext, const EGLint *))dlsym(
            libegl, "eglCreateContext");
    EGLBoolean (*makeCur)(EGLDisplay, EGLSurface, EGLSurface, EGLContext) =
        (EGLBoolean(*)(EGLDisplay, EGLSurface, EGLSurface, EGLContext))dlsym(
            libegl, "eglMakeCurrent");
    if (!getPlatDpy || !init || !bindAPI || !chooseCfg || !createCtx || !makeCur)
        return false;

    EGLDisplay dpy = getPlatDpy(EGL_PLATFORM_SURFACELESS_MESA, nullptr, nullptr);
    if (!dpy) return false;
    EGLint maj, min;
    if (!init(dpy, &maj, &min)) return false;
    bindAPI(EGL_OPENGL_API);
    EGLint cfg_attr[] = {EGL_SURFACE_TYPE, EGL_PBUFFER_BIT, EGL_RENDERABLE_TYPE,
                         EGL_OPENGL_BIT, EGL_NONE};
    EGLConfig cfg;
    EGLint n = 0;
    chooseCfg(dpy, cfg_attr, &cfg, 1, &n);
    // Compatibility profile: the corpus contains GLSL 1.10-1.20 era
    // shaders (varying/attribute/texture2D) next to 3.30 ones.
    EGLint ctx_attr[] = {EGL_CONTEXT_MAJOR_VERSION, 3, EGL_CONTEXT_MINOR_VERSION, 3,
                         EGL_CONTEXT_OPENGL_PROFILE_MASK, EGL_CONTEXT_OPENGL_COMPAT_BIT,
                         EGL_NONE};
    EGLContext ctx = createCtx(dpy, n ? cfg : nullptr, nullptr, ctx_attr);
    if (!ctx) return false;
    if (!makeCur(dpy, nullptr, nullptr, ctx)) return false;

#define LOAD(name)                                                 \
    name = (decltype(name))egl_get_proc(#name);                    \
    if (!name) {                                                   \
        fprintf(stderr, "gloracle: missing GL symbol %s\n", #name); \
        return false;                                              \
    }
    LOAD(glCreateShader) LOAD(glShaderSource) LOAD(glCompileShader)
    LOAD(glGetShaderiv) LOAD(glGetShaderInfoLog) LOAD(glCreateProgram)
    LOAD(glAttachShader) LOAD(glBindAttribLocation) LOAD(glLinkProgram)
    LOAD(glGetProgramiv) LOAD(glGetProgramInfoLog) LOAD(glUseProgram)
    LOAD(glDeleteShader) LOAD(glDeleteProgram) LOAD(glGetUniformLocation)
    LOAD(glUniform1i) LOAD(glUniform1f) LOAD(glUniform2f) LOAD(glUniform3f)
    LOAD(glUniform4f) LOAD(glUniformMatrix4fv) LOAD(glGenTextures)
    LOAD(glDeleteTextures) LOAD(glBindTexture) LOAD(glActiveTexture)
    LOAD(glTexImage2D) LOAD(glTexParameteri) LOAD(glTexParameterfv)
    LOAD(glGenerateMipmap) LOAD(glGenFramebuffers) LOAD(glDeleteFramebuffers)
    LOAD(glBindFramebuffer) LOAD(glFramebufferTexture2D)
    LOAD(glCheckFramebufferStatus) LOAD(glViewport) LOAD(glClearColor)
    LOAD(glClear) LOAD(glDrawArrays) LOAD(glReadPixels) LOAD(glGenBuffers)
    LOAD(glBindBuffer) LOAD(glBufferData) LOAD(glVertexAttribPointer)
    LOAD(glEnableVertexAttribArray) LOAD(glGenVertexArrays)
    LOAD(glBindVertexArray) LOAD(glEnable) LOAD(glDisable) LOAD(glPixelStorei)
    LOAD(glFinish)
#undef LOAD
    return true;
}

// ---- tiny JSON parser (flat, schema-known) -------------------------------
// The header is machine-generated by our own Python driver, so this
// parser handles exactly that subset: objects, arrays, strings with \\
// escapes, numbers, bools.

struct JV {
    enum Kind { Null, Bool, Num, Str, Arr, Obj } kind = Null;
    bool b = false;
    double num = 0;
    std::string str;
    std::vector<JV> arr;
    std::vector<std::pair<std::string, JV>> obj;
    const JV *get(const std::string &k) const {
        for (auto &kv : obj)
            if (kv.first == k) return &kv.second;
        return nullptr;
    }
};

struct JParse {
    const char *p, *end;
    bool fail = false;
    JParse(const char *s, size_t n) : p(s), end(s + n) {}
    void ws() {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r')) p++;
    }
    JV parse() {
        ws();
        JV v;
        if (p >= end) { fail = true; return v; }
        char c = *p;
        if (c == '{') return obj();
        if (c == '[') return arr();
        if (c == '"') { v.kind = JV::Str; v.str = str(); return v; }
        if (c == 't' || c == 'f') {
            v.kind = JV::Bool;
            v.b = (c == 't');
            while (p < end && *p != ',' && *p != '}' && *p != ']') p++;
            return v;
        }
        if (c == 'n') {
            while (p < end && *p != ',' && *p != '}' && *p != ']') p++;
            return v;
        }
        v.kind = JV::Num;
        char *e = nullptr;
        v.num = strtod(p, &e);
        p = e;
        return v;
    }
    std::string str() {
        std::string out;
        p++;  // opening quote
        while (p < end && *p != '"') {
            if (*p == '\\' && p + 1 < end) {
                p++;
                switch (*p) {
                    case 'n': out += '\n'; break;
                    case 't': out += '\t'; break;
                    case 'r': out += '\r'; break;
                    case 'u': {
                        // only ASCII escapes appear in our headers
                        if (p + 4 < end) {
                            int code = strtol(std::string(p + 1, p + 5).c_str(), nullptr, 16);
                            out += (char)code;
                            p += 4;
                        }
                        break;
                    }
                    default: out += *p;
                }
            } else {
                out += *p;
            }
            p++;
        }
        p++;  // closing quote
        return out;
    }
    JV obj() {
        JV v;
        v.kind = JV::Obj;
        p++;
        ws();
        if (p < end && *p == '}') { p++; return v; }
        while (p < end) {
            ws();
            std::string k = str();
            ws();
            p++;  // ':'
            v.obj.emplace_back(k, parse());
            ws();
            if (p < end && *p == ',') { p++; continue; }
            break;
        }
        if (p < end && *p == '}') p++;
        return v;
    }
    JV arr() {
        JV v;
        v.kind = JV::Arr;
        p++;
        ws();
        if (p < end && *p == ']') { p++; return v; }
        while (p < end) {
            v.arr.push_back(parse());
            ws();
            if (p < end && *p == ',') { p++; continue; }
            break;
        }
        if (p < end && *p == ']') p++;
        return v;
    }
};

// ---- helpers --------------------------------------------------------------

static bool read_exact(void *buf, size_t n) {
    return fread(buf, 1, n, stdin) == n;
}

static void respond_err(const std::string &msg) {
    uint32_t status = 1, len = (uint32_t)msg.size();
    fwrite(&status, 4, 1, stdout);
    fwrite(&len, 4, 1, stdout);
    fwrite(msg.data(), 1, len, stdout);
    fflush(stdout);
}

static GLenum wrap_enum(const std::string &w) {
    if (w == "repeat") return GL_REPEAT;
    if (w == "mirrored_repeat") return GL_MIRRORED_REPEAT;
    if (w == "clamp_to_border") return GL_CLAMP_TO_BORDER;
    return GL_CLAMP_TO_EDGE;
}

static GLuint compile(GLenum kind, const std::string &src, std::string &err) {
    GLuint sh = glCreateShader(kind);
    const char *s = src.c_str();
    glShaderSource(sh, 1, &s, nullptr);
    glCompileShader(sh);
    GLint ok = 0;
    glGetShaderiv(sh, GL_COMPILE_STATUS, &ok);
    if (!ok) {
        GLint len = 0;
        glGetShaderiv(sh, GL_INFO_LOG_LENGTH, &len);
        std::vector<char> log(len + 1);
        glGetShaderInfoLog(sh, len, nullptr, log.data());
        err = std::string(kind == GL_VERTEX_SHADER ? "vertex: " : "fragment: ") + log.data();
        glDeleteShader(sh);
        return 0;
    }
    return sh;
}

int main() {
    if (!load_gl()) {
        respond_err("failed to initialize EGL/GL (llvmpipe)");
        return 1;
    }
    // Fullscreen quad: VertexCoord (x,y,0,1), TexCoord (u,v,0,1), COLOR=1.
    // Attribute slots follow ShaderEngine.cpp:707-719's binding protocol.
    static const float quad[] = {
        // x,    y,   z, w,   u, v, s, t,   r, g, b, a
        -1.f, -1.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 1.f, 1.f,
         1.f, -1.f, 0.f, 1.f, 1.f, 0.f, 0.f, 1.f, 1.f, 1.f, 1.f, 1.f,
        -1.f,  1.f, 0.f, 1.f, 0.f, 1.f, 0.f, 1.f, 1.f, 1.f, 1.f, 1.f,
         1.f,  1.f, 0.f, 1.f, 1.f, 1.f, 0.f, 1.f, 1.f, 1.f, 1.f, 1.f,
    };
    GLuint vao = 0, vbo = 0;
    glGenVertexArrays(1, &vao);
    glBindVertexArray(vao);
    glGenBuffers(1, &vbo);
    glBindBuffer(GL_ARRAY_BUFFER, vbo);
    glBufferData(GL_ARRAY_BUFFER, sizeof(quad), quad, GL_STATIC_DRAW);
    const GLsizei stride = 12 * sizeof(float);
    glVertexAttribPointer(0, 4, GL_FLOAT, 0, stride, (void *)0);
    glVertexAttribPointer(1, 4, GL_FLOAT, 0, stride, (void *)(4 * sizeof(float)));
    glVertexAttribPointer(2, 4, GL_FLOAT, 0, stride, (void *)(8 * sizeof(float)));
    glEnableVertexAttribArray(0);
    glEnableVertexAttribArray(1);
    glEnableVertexAttribArray(2);
    glDisable(GL_DEPTH_TEST);
    glDisable(GL_BLEND);
    glPixelStorei(GL_PACK_ALIGNMENT, 1);
    glPixelStorei(GL_UNPACK_ALIGNMENT, 1);

    while (true) {
        uint32_t hlen = 0;
        if (!read_exact(&hlen, 4)) break;  // EOF: done
        std::vector<char> hbuf(hlen);
        if (!read_exact(hbuf.data(), hlen)) break;
        JParse jp(hbuf.data(), hlen);
        JV h = jp.parse();

        const JV *vs = h.get("vs"), *fs = h.get("fs");
        int out_w = (int)h.get("out_w")->num, out_h = (int)h.get("out_h")->num;
        std::string fbo_kind = h.get("fbo") ? h.get("fbo")->str : "rgba8";

        // -- textures ---------------------------------------------------
        std::vector<GLuint> texids;
        const JV *texs = h.get("textures");
        size_t ntex = texs ? texs->arr.size() : 0;
        bool read_fail = false;
        for (size_t t = 0; t < ntex; ++t) {
            const JV &tj = texs->arr[t];
            int tw = (int)tj.get("w")->num, th = (int)tj.get("h")->num;
            std::vector<float> data((size_t)tw * th * 4);
            if (!read_exact(data.data(), data.size() * 4)) { read_fail = true; break; }
            GLuint id;
            glGenTextures(1, &id);
            glActiveTexture(GL_TEXTURE0 + (GLenum)t);
            glBindTexture(GL_TEXTURE_2D, id);
            glTexImage2D(GL_TEXTURE_2D, 0, GL_RGBA32F, tw, th, 0, GL_RGBA, GL_FLOAT,
                         data.data());
            bool linear = tj.get("linear") && tj.get("linear")->b;
            bool mip = tj.get("mipmap") && tj.get("mipmap")->b;
            GLenum wrap = wrap_enum(tj.get("wrap") ? tj.get("wrap")->str : "");
            if (mip) glGenerateMipmap(GL_TEXTURE_2D);
            glTexParameteri(GL_TEXTURE_2D, GL_TEXTURE_MIN_FILTER,
                            mip ? GL_LINEAR_MIPMAP_LINEAR : (linear ? GL_LINEAR : GL_NEAREST));
            glTexParameteri(GL_TEXTURE_2D, GL_TEXTURE_MAG_FILTER,
                            linear ? GL_LINEAR : GL_NEAREST);
            glTexParameteri(GL_TEXTURE_2D, GL_TEXTURE_WRAP_S, wrap);
            glTexParameteri(GL_TEXTURE_2D, GL_TEXTURE_WRAP_T, wrap);
            static const float border[4] = {0, 0, 0, 0};
            glTexParameterfv(GL_TEXTURE_2D, GL_TEXTURE_BORDER_COLOR, border);
            texids.push_back(id);
        }
        if (read_fail) break;

        // -- program ----------------------------------------------------
        std::string err;
        GLuint vsh = compile(GL_VERTEX_SHADER, vs->str, err);
        GLuint fsh = vsh ? compile(GL_FRAGMENT_SHADER, fs->str, err) : 0;
        GLuint prog = 0;
        if (vsh && fsh) {
            prog = glCreateProgram();
            glAttachShader(prog, vsh);
            glAttachShader(prog, fsh);
            static const char *slot0[] = {"Position", "VertexCoord"};
            static const char *slot1[] = {"TexCoord", "PrevTexCoord", "Prev1TexCoord",
                                          "Prev2TexCoord", "Prev3TexCoord",
                                          "Prev4TexCoord", "Prev5TexCoord",
                                          "Prev6TexCoord"};
            for (auto *n : slot0) glBindAttribLocation(prog, 0, n);
            for (auto *n : slot1) glBindAttribLocation(prog, 1, n);
            glBindAttribLocation(prog, 2, "COLOR");
            glBindAttribLocation(prog, 2, "Color");
            glLinkProgram(prog);
            GLint ok = 0;
            glGetProgramiv(prog, GL_LINK_STATUS, &ok);
            if (!ok) {
                GLint len = 0;
                glGetProgramiv(prog, GL_INFO_LOG_LENGTH, &len);
                std::vector<char> log(len + 1);
                glGetProgramInfoLog(prog, len, nullptr, log.data());
                err = std::string("link: ") + log.data();
                glDeleteProgram(prog);
                prog = 0;
            }
        }
        if (vsh) glDeleteShader(vsh);
        if (fsh) glDeleteShader(fsh);
        if (!prog) {
            glDeleteTextures((GLsizei)texids.size(), texids.data());
            respond_err(err.empty() ? "program build failed" : err);
            continue;
        }
        glUseProgram(prog);

        // -- uniforms ---------------------------------------------------
        const JV *unis = h.get("uniforms");
        if (unis) {
            for (const JV &u : unis->arr) {
                GLint loc = glGetUniformLocation(prog, u.get("name")->str.c_str());
                if (loc < 0) continue;
                const std::string &kind = u.get("kind")->str;
                const std::vector<JV> &v = u.get("v")->arr;
                if (kind == "i")
                    glUniform1i(loc, (GLint)v[0].num);
                else if (kind == "f")
                    glUniform1f(loc, (float)v[0].num);
                else if (kind == "2f")
                    glUniform2f(loc, (float)v[0].num, (float)v[1].num);
                else if (kind == "3f")
                    glUniform3f(loc, (float)v[0].num, (float)v[1].num, (float)v[2].num);
                else if (kind == "4f")
                    glUniform4f(loc, (float)v[0].num, (float)v[1].num, (float)v[2].num,
                                (float)v[3].num);
                else if (kind == "m4") {
                    float m[16];
                    for (int i = 0; i < 16; ++i) m[i] = (float)v[i].num;
                    glUniformMatrix4fv(loc, 1, 0, m);
                }
            }
        }
        // sampler units by texture order
        for (size_t t = 0; t < ntex; ++t) {
            GLint loc = glGetUniformLocation(prog, texs->arr[t].get("name")->str.c_str());
            if (loc >= 0) glUniform1i(loc, (GLint)t);
        }

        // -- FBO --------------------------------------------------------
        GLenum ifmt = fbo_kind == "rgba32f" ? GL_RGBA32F
                      : fbo_kind == "srgb8" ? GL_SRGB8_ALPHA8
                                            : GL_RGBA8;
        GLuint out_tex, fbo;
        glGenTextures(1, &out_tex);
        glActiveTexture(GL_TEXTURE0 + (GLenum)ntex);
        glBindTexture(GL_TEXTURE_2D, out_tex);
        glTexImage2D(GL_TEXTURE_2D, 0, (GLint)ifmt, out_w, out_h, 0, GL_RGBA, GL_FLOAT,
                     nullptr);
        glGenFramebuffers(1, &fbo);
        glBindFramebuffer(GL_FRAMEBUFFER, fbo);
        glFramebufferTexture2D(GL_FRAMEBUFFER, GL_COLOR_ATTACHMENT0, GL_TEXTURE_2D,
                               out_tex, 0);
        if (glCheckFramebufferStatus(GL_FRAMEBUFFER) != GL_FRAMEBUFFER_COMPLETE) {
            respond_err("framebuffer incomplete");
            glDeleteFramebuffers(1, &fbo);
            glDeleteTextures(1, &out_tex);
            glDeleteTextures((GLsizei)texids.size(), texids.data());
            glDeleteProgram(prog);
            continue;
        }
        if (ifmt == GL_SRGB8_ALPHA8)
            glEnable(GL_FRAMEBUFFER_SRGB);  // ShaderEngine.cpp:938-952
        else
            glDisable(GL_FRAMEBUFFER_SRGB);

        glViewport(0, 0, out_w, out_h);
        glClearColor(0, 0, 0, 0);
        glClear(GL_COLOR_BUFFER_BIT);
        glBindVertexArray(vao);
        glDrawArrays(GL_TRIANGLE_STRIP, 0, 4);
        glFinish();

        std::vector<float> out((size_t)out_w * out_h * 4);
        glReadPixels(0, 0, out_w, out_h, GL_RGBA, GL_FLOAT, out.data());

        uint32_t status = 0, plen = (uint32_t)(out.size() * 4);
        fwrite(&status, 4, 1, stdout);
        fwrite(&plen, 4, 1, stdout);
        fwrite(out.data(), 1, plen, stdout);
        fflush(stdout);

        glBindFramebuffer(GL_FRAMEBUFFER, 0);
        glDeleteFramebuffers(1, &fbo);
        glDeleteTextures(1, &out_tex);
        glDeleteTextures((GLsizei)texids.size(), texids.data());
        glDeleteProgram(prog);
    }
    return 0;
}
